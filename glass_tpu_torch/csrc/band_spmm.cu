// Banded-slab SpMM for Hopper (sm_90a), f32 / bf16 / int8 slabs:
//   out = scale[row] * (A @ x).
//
// Replaces the Pallas TPU bodies of glass_tpu/ops/pallas_band.py and
// glass_tpu/ops/pallas_dense.py that compute one function:
//   _band_kernel_affine     (pallas_band.py:658, affine law, f32/bf16 slabs)
//   _band_kernel_affine_q   (pallas_band.py:714, affine law, int8 slabs,
//                            per-row scale in the kernel)
//   _band_kernel            (pallas_band.py:465, per-group windows, streamed)
//   _band_kernel_xvmem      (pallas_band.py:505, per-group windows, x resident)
//   _band_kernel_xvmem_gps  (pallas_band.py:543, gps groups per step)
//   _band_kernel_gps        (pallas_band.py:605, gps groups, x streamed)
//   _band_kernel_striped    (pallas_band.py:793, the slab copy in stripes)
//   _kernel                 (pallas_dense.py:82, row-quantized int8 dense)
// Each computes, for every row-block group g,
//   out[g*rps*128 + r, :H] = scale[r] * sum_k slabs[g, r, k] * x[clo[g]*128 + k, :H]
// over k < w_blocks*128, and they differ only in how slabs and x reach the
// TPU's VMEM. The int8 dense layout is such a layout: one 128-row group per
// row block (rps 1), a window of every column block, clo 0. Rows of x
// outside [0, n_x) read as zero: the JAX wrappers pad x with zeros; this
// kernel masks the rows instead, so it needs no pass over x.
//
// Numerics (those of the MXU, which this kernel reproduces up to the order
// of the sum): bf16 and int8 slabs multiply bf16 x, so f32 x is rounded to
// nearest even as it is staged (pallas_band.py:870-871, pallas_dense.py:147);
// f32 slabs multiply f32 x, and bf16 x is widened exactly (:707-708). int8
// widens to bf16 exactly and a product of two bf16 values is exact in f32,
// so every product is exact and the sum is taken in f32. The per-row scale
// (int8 only: bf16-rounded values for the band, f32 for the dense layout)
// multiplies the f32 sum once. The output is always f32.
//
// Layout (built on the host, identical to the JAX builders'):
//   slabs (n_g, rps*128, w_blocks*128) f32 | bf16 (as uint16 bits) | int8
//   clo   (n_g,) int32 window start of each group in 128-column blocks, or
//         null for windows that all start at column 0 (the dense layout)
//   scale (n_g*rps*128,) f32 or null
//
// Design. One CTA per (128-row block of one group, 64-column tile of H,
// split of the window); the TPU's sequential grid over groups becomes
// independent CTAs, and the window's columns become a loop inside the CTA
// in 32-deep stages through shared memory (spmm_common.cuh): f32 slabs on
// CUDA cores in f32 FMA (not TF32: parity with Precision.HIGHEST), bf16 and
// int8 slabs on the tensor cores with mma.sync m16n8k16 (bf16 products,
// f32 sums). With one split the tile is written once, scaled, rows at or
// past n_node masked. A layout with too few row blocks to fill the card
// (the dense layout: 114 row blocks at 14,587 nodes) splits the window:
// each split writes its partial tile to a scratch buffer and
// split_reduce_kernel adds the splits in a fixed order and scales. No
// atomics anywhere, so a repeated call is bit-identical.
//
// Bounds on this card, at the shapes the port runs:
//   em_user band (57,344 nodes, 9M edges, rps 2, w_blocks 4, H = 64): 1,342
//   nonzero 128x128 blocks. f32 slabs and x: 117 MB, 35 us at 3.35 TB/s,
//   against 2.8 GFLOP of f32 FMA, 42 us at 67 TFLOP/s: operations. int8
//   slabs with bf16 x: 44 MB, 13 us, against 2.8 GFLOP of bf16 products,
//   2.8 us on the tensor cores: bytes.
//   int8 dense at 14,587 nodes (hpo, H = 64): 213 MB of q, 65 us, against
//   27 GFLOP, 28 us on the tensor cores: bytes.
// This kernel multiplies the band's zero blocks too, and stages every slab
// through registers and shared memory in one buffer (no cp.async or TMA
// pipeline, no wgmma): those, and skipping empty blocks, are later work.

#include "spmm_common.cuh"

namespace {

using spmm::BLOCK;
using spmm::TN;
using spmm::TK;
using spmm::THREADS;

template <typename S, typename X>
__global__ void __launch_bounds__(THREADS)
band_spmm_kernel(const S* __restrict__ slabs,
                 const int* __restrict__ clo,
                 const float* __restrict__ row_scale,
                 const X* __restrict__ x,
                 float* __restrict__ out,  // (splits, n_out_rows, h)
                 int rps, int w_blocks, int n_x_rows, int n_out_rows,
                 int h, int split_blocks) {
  __shared__ spmm::StageSmem sm;

  const int rb = blockIdx.x;            // row block over all groups
  const long long row0 = static_cast<long long>(rb) * BLOCK;
  if (row0 >= n_out_rows) return;       // the last group's padding blocks
  const int g = rb / rps;
  const int h0 = blockIdx.y * TN;
  const long long kw = static_cast<long long>(w_blocks) * BLOCK;  // slab row
  const long long k_lo = static_cast<long long>(blockIdx.z) * split_blocks * BLOCK;
  const long long k_hi = min(kw, k_lo + static_cast<long long>(split_blocks) * BLOCK);

  // rows (rb % rps)*128 .. +128 of group g's slab
  const S* a_blk = slabs + (static_cast<long long>(g) * rps + rb % rps) * BLOCK * kw;
  const long long x_row0 = clo ? static_cast<long long>(clo[g]) * BLOCK : 0;

  spmm::Tile<S> t;
  spmm::zero(t);
  for (long long k0 = k_lo; k0 < k_hi; k0 += TK)
    spmm::stage<S, X>(a_blk + k0, kw, x, x_row0 + k0, n_x_rows, h, h0, sm, t);

  // one split: the scaled tile is the output; several: unscaled partials
  const bool scaled = gridDim.z == 1 && row_scale != nullptr;
  float* dst = out + static_cast<long long>(blockIdx.z) * n_out_rows * h;
  spmm::for_each(t, [&](int r, int c, float v) {
    const long long row = row0 + r;
    const int col = h0 + c;
    if (row < n_out_rows && col < h)
      dst[row * h + col] = scaled ? v * row_scale[row] : v;
  });
}

// out[i] = scale[row] * sum over splits of partial[split, i], in split order.
__global__ void split_reduce_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ row_scale,
                                    float* __restrict__ out, int splits,
                                    long long n, int h) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += partial[sp * n + i];
    out[i] = row_scale ? s * row_scale[i / h] : s;
  }
}

template <typename S, typename X>
int launch(const void* slabs, const int* clo, const float* row_scale,
           const void* x, float* out, float* partial, int n_g, int rps,
           int w_blocks, int n_x_rows, int n_out_rows, int h, int splits,
           int split_blocks, cudaStream_t stream) {
  const dim3 grid(n_g * rps, (h + TN - 1) / TN, splits);
  band_spmm_kernel<S, X><<<grid, THREADS, 0, stream>>>(
      static_cast<const S*>(slabs), clo, row_scale,
      static_cast<const X*>(x), splits == 1 ? out : partial, rps, w_blocks,
      n_x_rows, n_out_rows, h, split_blocks);
  if (splits > 1) {
    const long long n = static_cast<long long>(n_out_rows) * h;
    const long long blocks = (n + THREADS - 1) / THREADS;
    split_reduce_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535),
                          THREADS, 0, stream>>>(partial, row_scale, out,
                                                splits, n, h);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_x(int x_dtype, const void* slabs, const int* clo,
             const float* row_scale, const void* x, float* out,
             float* partial, int n_g, int rps, int w_blocks, int n_x_rows,
             int n_out_rows, int h, int splits, int split_blocks,
             cudaStream_t stream) {
  if (x_dtype == spmm::DT_F32)
    return launch<S, float>(slabs, clo, row_scale, x, out, partial, n_g, rps,
                            w_blocks, n_x_rows, n_out_rows, h, splits,
                            split_blocks, stream);
  if (x_dtype == spmm::DT_BF16)
    return launch<S, uint16_t>(slabs, clo, row_scale, x, out, partial, n_g,
                               rps, w_blocks, n_x_rows, n_out_rows, h, splits,
                               split_blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks every shape, allocates `out` (n_out_rows, h) and, when
// splits > 1, `partial` (splits, n_out_rows, h); the slabs cover
// n_g * rps >= ceil(n_out_rows / 128) row blocks; split s covers window
// blocks [s * split_blocks, (s + 1) * split_blocks).
extern "C" int glass_band_spmm(const void* slabs, int slab_dtype,
                               const int* clo, const float* row_scale,
                               const void* x, int x_dtype, float* out,
                               float* partial, int n_g, int rps, int w_blocks,
                               int n_x_rows, int n_out_rows, int h,
                               int splits, int split_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (slab_dtype == spmm::DT_F32)
    return launch_x<float>(x_dtype, slabs, clo, row_scale, x, out, partial,
                           n_g, rps, w_blocks, n_x_rows, n_out_rows, h,
                           splits, split_blocks, s);
  if (slab_dtype == spmm::DT_BF16)
    return launch_x<uint16_t>(x_dtype, slabs, clo, row_scale, x, out, partial,
                              n_g, rps, w_blocks, n_x_rows, n_out_rows, h,
                              splits, split_blocks, s);
  if (slab_dtype == spmm::DT_I8)
    return launch_x<int8_t>(x_dtype, slabs, clo, row_scale, x, out, partial,
                            n_g, rps, w_blocks, n_x_rows, n_out_rows, h,
                            splits, split_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

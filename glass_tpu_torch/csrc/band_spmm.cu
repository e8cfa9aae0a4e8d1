// Banded-slab SpMM for Hopper (sm_90a), f32 / bf16 / int8 slabs:
//   out = scale[row] * (A @ x).
//
// Replaces the Pallas TPU bodies of glass_tpu/ops/pallas_band.py that
// compute one function:
//   _band_kernel_affine     (:658, affine law, f32/bf16 slabs)
//   _band_kernel_affine_q   (:714, affine law, int8 slabs, per-row scale in
//                            the kernel)
//   _band_kernel            (:465, per-group windows, streamed)
//   _band_kernel_xvmem      (:505, per-group windows, x resident)
//   _band_kernel_xvmem_gps  (:543, gps groups per step)
//   _band_kernel_gps        (:605, gps groups, x streamed)
//   _band_kernel_striped    (:793, the slab copy in stripes)
// Each computes, for every row-block group g,
//   out[g*rps*128 + r, :H] = scale[r] * sum_k slabs[g, r, k] * x[clo[g]*128 + k, :H]
// (from row g_lo*rps*128 of a zero output for a row-range-trimmed layout,
// whose slabs hold groups g_lo .. g_lo + n_g - 1; see glass_band_spmm)
// over k < w_blocks*128, and they differ only in how slabs and x reach the
// TPU's VMEM. Rows of x outside [0, n_x) read as zero: the JAX wrappers pad
// x with zeros; this kernel masks the rows instead (f32 slabs) or the tensor
// map zero-fills them (bf16 and int8 slabs), so it needs no padded copy.
//
// Numerics (those of the MXU up to the order of the sum): bf16 and int8
// slabs multiply bf16 x, so f32 x is rounded to nearest even once by the
// wrapper (pallas_band.py:870-871); f32 slabs multiply f32 x, and bf16 x is
// widened exactly (:707-708). The per-row scale (int8 only, bf16-rounded values)
// multiplies the f32 sum once. The output is always f32.
//
// Layout (built on the host, identical to the JAX builders'):
//   slabs (n_g, rps*128, w_blocks*128) f32 | bf16 (as uint16 bits) | int8
//   clo   (n_g,) int32 window start of each group in 128-column blocks
//   scale (n_g*rps*128,) f32 or null
//
// Design. No atomics, so a repeated call is bit-identical.
//   f32 slabs: the 3xTF32 stages of spmm_common.cuh (band_tf32_kernel), one
//     CTA per (128-row block of one group, 64-column tile of H); the TPU's
//     sequential grid over groups becomes independent CTAs, and the
//     window's columns a loop inside the CTA in 32-deep stages through a
//     ring of RING slots filled by 16-byte cp.async.
//   bf16 and int8 slabs: spmm_common.cuh's TMA + wgmma pipeline over the
//     (n_g*rps*128, w_blocks*128) view of the slabs: row block rb's block j
//     is the A tile at column j*128, row rb*128, and multiplies x rows
//     (clo[rb / rps] + j)*128 .. +128 (a block whose x rows lie wholly
//     outside [0, n_x) adds zeros and is skipped); persistent CTAs, one an
//     SM, the ring running on across row blocks.
//
// Bounds on this card, at the shapes the port runs:
//   em_user band (57,344 nodes, 9M edges, rps 1, w_blocks 3, H = 64):
//   1,342 nonzero 128x128 blocks. f32 slabs and x: 117 MB, 35.0 us at 3.35
//   TB/s; as 3xTF32 8.4 GFLOP, 17 us at 495 TFLOP/s (as f32 FMA 2.8 GFLOP,
//   42 us at 67 TFLOP/s): bytes. int8 slabs with bf16 x: 44 MB, 13 us,
//   against 2.8 us of bf16 tensor-core products: bytes.
// The kernel multiplies the band's zero blocks too (1,344 stored blocks
// against 1,342 nonzero at em_user; 7 window blocks after RCM on the CLI's
// route): skipping them is later work.

#include "spmm_common.cuh"

namespace {

using spmm::BLOCK;
using spmm::RING;
using spmm::TK;
using spmm::TN;
using spmm::THREADS;

// ------------------------------------------------------- f32: 3xTF32

template <typename X, bool XA>
__global__ void __launch_bounds__(THREADS, 2)
band_tf32_kernel(const float* __restrict__ slabs, const int* __restrict__ clo,
                 const X* __restrict__ x, float* __restrict__ out, int rps,
                 int w_blocks, int n_x_rows, int n_out_rows, int h) {
  spmm::count_launch(spmm::DT_F32);
  extern __shared__ __align__(16) unsigned char smem[];
  spmm::Tf32Stage* ring = reinterpret_cast<spmm::Tf32Stage*>(smem);

  const int rb = blockIdx.x;            // row block over all groups
  const long long row0 = static_cast<long long>(rb) * BLOCK;
  if (row0 >= n_out_rows) return;       // the last group's padding blocks
  const int g = rb / rps;
  const int h0 = blockIdx.y * TN;
  const long long kw = static_cast<long long>(w_blocks) * BLOCK;  // slab row
  const float* a_blk = slabs + (static_cast<long long>(g) * rps + rb % rps) * BLOCK * kw;
  const long long x_row0 = static_cast<long long>(clo[g]) * BLOCK;
  const int n_stages = static_cast<int>(kw / TK);
  const int tid = threadIdx.x;

  // this thread's slab pieces (spmm::tf32_load_a)
  const float* a_src = a_blk + (tid / (TK / 4)) * kw + 4 * (tid % (TK / 4));
  const int a_dst = (tid / (TK / 4)) * spmm::A_LD + 4 * (tid % (TK / 4));

  auto load = [&](int s) {  // stage s into slot s % RING
    spmm::Tf32Stage& st = ring[s % RING];
    const long long k0 = static_cast<long long>(s) * TK;
    spmm::tf32_load_a(st, a_src + k0, a_dst, kw);
    spmm::tf32_load_x<X, XA>(st, x, x_row0 + k0, n_x_rows, h, h0);
  };

  spmm::MmaTile t;
  spmm::zero(t);
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < n_stages) load(s);
    spmm::cp_async_commit();  // one group per stage, empty ones too
  }
  for (int s = 0; s < n_stages; ++s) {
    spmm::cp_async_wait<RING - 2>();  // this thread's copies of stage s landed
    __syncthreads();  // everyone's; and slot (s - 1) % RING is free
    if (s + RING - 1 < n_stages) load(s + RING - 1);
    spmm::cp_async_commit();
    spmm::tf32_compute(ring[s % RING], t);
  }

  spmm::for_each(t, [&](int r, int c, float v) {
    const long long row = row0 + r;
    const int col = h0 + c;
    if (row < n_out_rows && col < h) out[row * h + col] = v;
  });
}

// ------------------------------------------- bf16 and int8: TMA + wgmma

struct BandWalk {
  const int* clo;
  int rps;
  int w_blocks;
  int n_xb;  // x's row blocks, ceil(n_x / 128)
  __device__ spmm::tc::Run run(int rb) const {
    const int c = clo[rb / rps];
    const int lo = c < 0 ? -c : 0;
    const int hi = n_xb - c < w_blocks ? n_xb - c : w_blocks;
    return {rb, lo, hi > lo ? hi - lo : 0, c};
  }
  __device__ spmm::tc::Pair pair(const spmm::tc::Run& r, int t) const {
    const int j = r.lo + t;
    return {j * BLOCK, r.rb * BLOCK, (r.aux + j) * BLOCK};
  }
};

template <typename S, typename X>
int launch(const void* slabs, const int* clo, const float* row_scale,
           const void* x, int x_ld, float* out, int n_g, int rps,
           int w_blocks, int n_x_rows, int n_out_rows, int h,
           cudaStream_t stream) {
  if constexpr (std::is_same<S, float>::value) {
    const dim3 grid(n_g * rps, (h + TN - 1) / TN);
    const bool xa = std::is_same<X, float>::value && h % 4 == 0 &&
                    n_x_rows > 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    auto kernel = xa ? band_tf32_kernel<X, true> : band_tf32_kernel<X, false>;
    const cudaError_t err = spmm::allow_smem(
        reinterpret_cast<const void*>(kernel), spmm::TF32_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, THREADS, spmm::TF32_SMEM, stream>>>(
        static_cast<const float*>(slabs), clo, static_cast<const X*>(x), out,
        rps, w_blocks, n_x_rows, n_out_rows, h);
    return static_cast<int>(cudaGetLastError());
  } else if constexpr (std::is_same<X, uint16_t>::value) {
    return spmm::tc::launch<S>(
        slabs, static_cast<long long>(n_g) * rps * BLOCK,
        static_cast<long long>(w_blocks) * BLOCK, x, n_x_rows, x_ld,
        BandWalk{clo, rps, w_blocks, (n_x_rows + BLOCK - 1) / BLOCK},
        row_scale, out, n_out_rows, h, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper rounds x
  }
}

template <typename S>
int launch_x(int x_dtype, const void* slabs, const int* clo,
             const float* row_scale, const void* x, int x_ld, float* out,
             int n_g, int rps, int w_blocks, int n_x_rows, int n_out_rows,
             int h, cudaStream_t stream) {
  if (x_dtype == spmm::DT_F32)
    return launch<S, float>(slabs, clo, row_scale, x, x_ld, out, n_g, rps,
                            w_blocks, n_x_rows, n_out_rows, h, stream);
  if (x_dtype == spmm::DT_BF16)
    return launch<S, uint16_t>(slabs, clo, row_scale, x, x_ld, out, n_g, rps,
                               w_blocks, n_x_rows, n_out_rows, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The launches of this library's kernels by slab dtype code (f32, bf16,
// int8) since the last reset (spmm_common.cuh count_launch).
extern "C" int glass_launches(unsigned long long* out, int reset) {
  return spmm::read_launches(out, reset);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks every shape and allocates `out` (n_out_rows, h); the slabs
// are 16-byte aligned. x: f32 or bf16 (n_x_rows, h) for f32 slabs; for bf16
// and int8 slabs bf16 with row stride x_ld (a multiple of 8, >= h) and
// n_x_rows >= 1.
//
// out_row0: the output row of the slabs' first row. 0 for a whole layout,
// whose slabs cover n_g * rps >= ceil(n_out_rows / 128) row blocks; for a
// row-range-trimmed layout (the sharded path's transposed layouts, which
// store groups [g_lo, g_lo + n_g) of their total) g_lo * rps * 128: the
// stored rows land at out_row0 .. out_row0 + n_g * rps * 128 (those below
// n_out_rows), and the caller allocates `out` zeroed, which the other rows
// stay. (pallas_band.py:1029-1035 writes them with a dynamic_update_slice
// into a zero output.)
extern "C" int glass_band_spmm(const void* slabs, int slab_dtype,
                               const int* clo, const float* row_scale,
                               const void* x, int x_dtype, int x_ld,
                               float* out, int n_g, int rps, int w_blocks,
                               int n_x_rows, int n_out_rows, int out_row0,
                               int h, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clo == nullptr || out_row0 < 0 || out_row0 >= n_out_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  // the stored rows' window of the output
  out += static_cast<long long>(out_row0) * h;
  const long long stored = static_cast<long long>(n_g) * rps * spmm::BLOCK;
  n_out_rows = static_cast<int>(n_out_rows - out_row0 < stored
                                    ? n_out_rows - out_row0 : stored);
  if (slab_dtype == spmm::DT_F32)
    return launch_x<float>(x_dtype, slabs, clo, row_scale, x, x_ld, out, n_g,
                           rps, w_blocks, n_x_rows, n_out_rows, h, s);
  if (slab_dtype == spmm::DT_BF16)
    return launch_x<uint16_t>(x_dtype, slabs, clo, row_scale, x, x_ld, out,
                              n_g, rps, w_blocks, n_x_rows, n_out_rows, h, s);
  if (slab_dtype == spmm::DT_I8)
    return launch_x<int8_t>(x_dtype, slabs, clo, row_scale, x, x_ld, out, n_g,
                            rps, w_blocks, n_x_rows, n_out_rows, h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

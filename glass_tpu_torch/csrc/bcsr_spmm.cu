// Chunked-BCSR SpMM for Hopper (sm_90a), f32 / bf16 / int8 blocks:
//   out = scale[row] * (A @ x).
//
// Replaces the two Pallas TPU kernels of glass_tpu/ops/pallas_spmm.py:
//   _bcsr_chunk_kernel        (:321, x resident in VMEM)
//   _bcsr_chunk_kernel_large  (:411, x row blocks streamed beside each chunk)
// Both compute, for every row block rb,
//   out[rb*128 : rb*128+128, :H] = sum over rb's stored chunks of
//       A_chunk (128 x CHUNK*128) @ vstack(x[block_col[j]*128 : +128])
// and differ only in how x reaches the TPU's VMEM. On Hopper the 50 MB L2
// plays the part of the resident copy, so one kernel covers both. int8
// blocks carry a per-row f32 scale, which the JAX wrapper applies after the
// kernel (pallas_spmm.py:585-586) and this kernel applies to the f32 sum
// (one multiply either way).
//
// Numerics: bf16 and int8 blocks multiply bf16 x (f32 x rounded to nearest
// even as it is staged, pallas_spmm.py:515-516); f32 blocks multiply f32 x
// (bf16 x widened exactly). Every product is exact in f32 and the sum is
// taken in f32, as the MXU does it up to the order of the sum.
//
// Layout (built on the host, identical to the JAX builder's):
//   blocks        (n_store, 128, CHUNK*128) f32 | bf16 (uint16 bits) | int8:
//                 stored block b is columns (b % CHUNK)*128 .. +128 of
//                 storage chunk b / CHUNK
//   block_col     (n_store*CHUNK,) int32 column block of each stored block
//   block_row_ptr (n_rb+1,) int32: row block rb owns stored blocks
//                 [ptr[rb], ptr[rb+1]); each run is padded with zero blocks
//                 to a multiple of CHUNK; an empty row block owns none.
//   row_scale     (n_rb*128,) f32 or null
//
// Design. One CTA per (row block, 64-column tile of H); the sequential TPU
// grid over chunks becomes a loop inside the CTA over the row's stored
// blocks, in order, each consumed in 32-deep stages through shared memory
// (spmm_common.cuh): f32 blocks on CUDA cores in f32 FMA (not TF32: parity
// with Precision.HIGHEST), bf16 and int8 blocks on the tensor cores with
// mma.sync m16n8k16 (bf16 products, f32 sums). The tile is written once at
// the end, scaled; an empty row block writes zeros (the Pallas placeholder
// chunk). No atomics, so results are the same from run to run. Any H
// works: columns past H and rows of x past its end read as zero (the JAX
// wrapper's zero padding of x).
//
// Bound at the em_user serving shape (57,344 nodes, 9M edges, H = 64): the
// function needs the 1,342 nonzero 128x128 blocks. f32: 88 MB of blocks, x
// and out 14.7 MB each, about 117 MB, 35 us at 3.35 TB/s, against 2.8 GFLOP
// of f32 FMA, 42 us at 67 TFLOP/s: operations. int8 blocks with bf16 x:
// 22 MB + 7.3 MB + 14.7 MB, 13 us, against 2.8 us of bf16 tensor-core
// products: bytes. This kernel also runs the CHUNK-padding blocks (3,584
// stored blocks, 2.7x the work) and stages A through registers in one
// buffer; skipping the padding, a cp.async or TMA pipeline and wgmma are
// later work.

#include "spmm_common.cuh"

namespace {

using spmm::BLOCK;
using spmm::TN;
using spmm::TK;
using spmm::THREADS;
constexpr int CHUNK = 8;               // blocks per stored wide chunk
constexpr int KW = CHUNK * BLOCK;      // values in one row of a stored chunk

template <typename S, typename X>
__global__ void __launch_bounds__(THREADS)
bcsr_spmm_kernel(const S* __restrict__ blocks,
                 const int* __restrict__ block_col,
                 const int* __restrict__ block_row_ptr,
                 const float* __restrict__ row_scale,
                 const X* __restrict__ x,
                 float* __restrict__ out,
                 int n_x_rows, int n_out_rows, int h) {
  __shared__ spmm::StageSmem sm;

  const int rb = blockIdx.x;
  const int h0 = blockIdx.y * TN;
  spmm::Tile<S> t;
  spmm::zero(t);
  const int b_lo = block_row_ptr[rb];
  const int b_hi = block_row_ptr[rb + 1];
  for (int b = b_lo; b < b_hi; ++b) {
    const S* a_blk =
        blocks + static_cast<long long>(b / CHUNK) * BLOCK * KW +
        (b % CHUNK) * BLOCK;
    const long long x_row0 = static_cast<long long>(block_col[b]) * BLOCK;
    for (int k0 = 0; k0 < BLOCK; k0 += TK)
      spmm::stage<S, X>(a_blk + k0, KW, x, x_row0 + k0, n_x_rows, h, h0, sm, t);
  }

  const long long row0 = static_cast<long long>(rb) * BLOCK;
  spmm::for_each(t, [&](int r, int c, float v) {
    const long long row = row0 + r;
    const int col = h0 + c;
    if (row < n_out_rows && col < h)
      out[row * h + col] = row_scale ? v * row_scale[row] : v;
  });
}

template <typename S, typename X>
int launch(const void* blocks, const int* block_col, const int* block_row_ptr,
           const float* row_scale, const void* x, float* out, int n_rb,
           int n_x_rows, int n_out_rows, int h, cudaStream_t stream) {
  const dim3 grid(n_rb, (h + TN - 1) / TN);
  bcsr_spmm_kernel<S, X><<<grid, THREADS, 0, stream>>>(
      static_cast<const S*>(blocks), block_col, block_row_ptr, row_scale,
      static_cast<const X*>(x), out, n_x_rows, n_out_rows, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_x(int x_dtype, const void* blocks, const int* block_col,
             const int* block_row_ptr, const float* row_scale, const void* x,
             float* out, int n_rb, int n_x_rows, int n_out_rows, int h,
             cudaStream_t stream) {
  if (x_dtype == spmm::DT_F32)
    return launch<S, float>(blocks, block_col, block_row_ptr, row_scale, x,
                            out, n_rb, n_x_rows, n_out_rows, h, stream);
  if (x_dtype == spmm::DT_BF16)
    return launch<S, uint16_t>(blocks, block_col, block_row_ptr, row_scale, x,
                               out, n_rb, n_x_rows, n_out_rows, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (n_out_rows, h) and checks every shape.
extern "C" int glass_bcsr_spmm(const void* blocks, int block_dtype,
                               const int* block_col, const int* block_row_ptr,
                               const float* row_scale, const void* x,
                               int x_dtype, float* out, int n_rb,
                               int n_x_rows, int n_out_rows, int h,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_dtype == spmm::DT_F32)
    return launch_x<float>(x_dtype, blocks, block_col, block_row_ptr,
                           row_scale, x, out, n_rb, n_x_rows, n_out_rows, h, s);
  if (block_dtype == spmm::DT_BF16)
    return launch_x<uint16_t>(x_dtype, blocks, block_col, block_row_ptr,
                              row_scale, x, out, n_rb, n_x_rows, n_out_rows,
                              h, s);
  if (block_dtype == spmm::DT_I8)
    return launch_x<int8_t>(x_dtype, blocks, block_col, block_row_ptr,
                            row_scale, x, out, n_rb, n_x_rows, n_out_rows, h,
                            s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Chunked-BCSR SpMM for Hopper (sm_90a), f32:  out = A @ x.
//
// Replaces the two Pallas TPU kernels of glass_tpu/ops/pallas_spmm.py:
//   _bcsr_chunk_kernel        (:321, x resident in VMEM)
//   _bcsr_chunk_kernel_large  (:411, x row blocks streamed beside each chunk)
// Both compute, for every row block rb,
//   out[rb*128 : rb*128+128, :H] = sum over rb's stored chunks of
//       A_chunk (128 x CHUNK*128) @ vstack(x[block_col[j]*128 : +128])
// and differ only in how x reaches the TPU's VMEM. On Hopper the 50 MB L2
// plays the part of the resident copy, so one kernel covers both.
//
// Layout (built on the host, identical to the JAX builder's):
//   blocks        (n_store, 128, CHUNK*128) f32: stored block b is columns
//                 (b % CHUNK)*128 .. +128 of storage chunk b / CHUNK
//   block_col     (n_store*CHUNK,) int32 column block of each stored block
//   block_row_ptr (n_rb+1,) int32: row block rb owns stored blocks
//                 [ptr[rb], ptr[rb+1]); each run is padded with zero blocks
//                 to a multiple of CHUNK; an empty row block owns none.
//
// Design. One CTA per (row block, 64-column tile of H); the sequential TPU
// grid over chunks becomes a loop inside the CTA over the row's stored
// blocks, in order. Each 128-deep block is consumed in 32-deep stages: the
// A stage (128 x 32, 16-byte loads, stored transposed with a padded stride
// so neither the stores nor the reads conflict on banks) and the x stage
// (32 x 64) go through shared memory, and each of the 256 threads keeps an
// 8 x 4 tile of the output in f32 registers, updated with fmaf. The tile is
// written once at the end; an empty row block writes zeros (the Pallas
// placeholder chunk). No atomics, so results are the same from run to run;
// f32 FMA, not TF32, for parity with Precision.HIGHEST. Any H works: the x
// stage and the write mask columns past H, and rows of x past its end read
// as zero (the JAX wrapper's zero padding of x).
//
// Bound at the em_user serving shape (57,344 nodes, 9M edges, H = 64): the
// function needs the 1,342 nonzero 128x128 blocks (88 MB f32), x and out
// (14.7 MB each): about 117 MB, 35 us at 3.35 TB/s; and 1,342 * 2 * 128^2 *
// 64 = 2.8 GFLOP of f32 FMA, 42 us at 67 TFLOP/s. Operations bound it. This
// first kernel also runs the CHUNK-padding blocks (3,584 stored blocks, 2.7x
// the work) and reads A through plain loads on CUDA cores; skipping the
// padding, TMA and wgmma are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;             // adjacency block edge
constexpr int CHUNK = 8;               // blocks per stored wide chunk
constexpr int KW = CHUNK * BLOCK;      // floats in one row of a stored chunk
constexpr int TN = 64;                 // output columns per CTA
constexpr int TK = 32;                 // depth of one shared-memory stage
constexpr int THREADS = 256;           // 16 x 16 threads
constexpr int RM = BLOCK / 16;         // output rows per thread (strided by 16)
constexpr int RN = TN / 16;            // output columns per thread (strided)
constexpr int A_STRIDE = BLOCK + 1;    // transposed A stage row, padded

static_assert(BLOCK % TK == 0, "a stage must not straddle two blocks");
static_assert((BLOCK * TK / 4) % THREADS == 0, "A stage: whole float4s");
static_assert((TK * TN) % THREADS == 0, "x stage: whole floats");

__global__ void __launch_bounds__(THREADS)
bcsr_spmm_f32_kernel(const float* __restrict__ blocks,
                     const int* __restrict__ block_col,
                     const int* __restrict__ block_row_ptr,
                     const float* __restrict__ x,
                     float* __restrict__ out,
                     int n_x_rows, int n_out_rows, int h) {
  __shared__ float a_s[TK * A_STRIDE];  // a_s[k * A_STRIDE + row]
  __shared__ float x_s[TK * TN];        // x_s[k * TN + col]

  const int rb = blockIdx.x;
  const int h0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int b_lo = block_row_ptr[rb];
  const int b_hi = block_row_ptr[rb + 1];
  for (int b = b_lo; b < b_hi; ++b) {
    const float* a_blk =
        blocks + static_cast<long long>(b / CHUNK) * BLOCK * KW +
        (b % CHUNK) * BLOCK;
    const long long x_row0 = static_cast<long long>(block_col[b]) * BLOCK;
    for (int k0 = 0; k0 < BLOCK; k0 += TK) {
#pragma unroll
      for (int p = 0; p < BLOCK * TK / 4 / THREADS; ++p) {
        const int idx = tid + p * THREADS;
        const int r = idx / (TK / 4);  // row of the block
        const int q = idx % (TK / 4);  // float4 along k
        const float4 v = *reinterpret_cast<const float4*>(
            a_blk + static_cast<long long>(r) * KW + k0 + q * 4);
        a_s[(q * 4 + 0) * A_STRIDE + r] = v.x;
        a_s[(q * 4 + 1) * A_STRIDE + r] = v.y;
        a_s[(q * 4 + 2) * A_STRIDE + r] = v.z;
        a_s[(q * 4 + 3) * A_STRIDE + r] = v.w;
      }
#pragma unroll
      for (int p = 0; p < TK * TN / THREADS; ++p) {
        const int idx = tid + p * THREADS;
        const int k = idx / TN;
        const int c = idx % TN;
        const long long xr = x_row0 + k0 + k;
        const int col = h0 + c;
        x_s[k * TN + c] =
            (xr < n_x_rows && col < h) ? x[xr * h + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        float a[RM];
        float xv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = a_s[k * A_STRIDE + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) xv[j] = x_s[k * TN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long r = static_cast<long long>(rb) * BLOCK + ty + 16 * i;
    if (r >= n_out_rows) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = h0 + tx + 16 * j;
      if (col < h) out[r * h + col] = acc[i][j];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (n_out_rows, h) and checks every shape.
extern "C" int glass_bcsr_spmm_f32(const float* blocks, const int* block_col,
                                   const int* block_row_ptr, const float* x,
                                   float* out, int n_rb, int n_x_rows,
                                   int n_out_rows, int h, void* stream) {
  const dim3 grid(n_rb, (h + TN - 1) / TN);
  bcsr_spmm_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, block_col, block_row_ptr, x, out, n_x_rows, n_out_rows, h);
  return static_cast<int>(cudaGetLastError());
}

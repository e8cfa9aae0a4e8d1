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
// even once by the wrapper, pallas_spmm.py:515-516); f32 blocks multiply f32
// x (bf16 x widened exactly) as 3xTF32. See spmm_common.cuh.
//
// Layout (built on the host, identical to the JAX builder's, plus one table):
//   blocks        (n_store, 128, CHUNK*128) f32 | bf16 (uint16 bits) | int8:
//                 stored block b is columns (b % CHUNK)*128 .. +128 of
//                 storage chunk b / CHUNK
//   block_col     (n_store*CHUNK,) int32 column block of each stored block
//   block_row_ptr (n_rb+1,) int32: row block rb owns stored blocks
//                 [ptr[rb], ptr[rb+1]); each run is padded with zero blocks
//                 to a multiple of CHUNK; an empty row block owns none.
//   block_row_end (n_rb,) int32: the end of rb's nonzero blocks, which come
//                 first in its run (the port's own table; the padding after
//                 it is never read)
//   row_scale     (n_rb*128,) f32 or null
//
// Design. The kernel walks [ptr[rb], end[rb]) only: at em_user 1,342 live
// blocks of 3,584 stored. Persistent CTAs take row blocks rb = blockIdx.x +
// i * gridDim.x, one 64-column tile of H each, and their copies run on
// across row blocks (about 3 live blocks a row block at em_user), with one
// epilogue per row block (scaled; zeros for an empty one, the Pallas
// placeholder chunk):
//   f32 blocks: the 3xTF32 stages of spmm_common.cuh, a cp.async ring of
//     RING 32-deep stages, 2 CTAs an SM; x by 16-byte cp.async when it is
//     f32 with h % 4 == 0, else loaded and widened by the threads.
//   bf16 and int8 blocks: spmm_common.cuh's TMA + wgmma pipeline over the
//     (n_store*128, CHUNK*128) view of the blocks, block b's A tile at
//     column (b % CHUNK)*128, row (b / CHUNK)*128, its x tile at row
//     block_col[b]*128; one CTA an SM.
// No atomics, so results are the same from run to run. Any H works: columns
// past H and rows of x past its end read as zero (the JAX wrapper's zero
// padding of x).
//
// Bound at the em_user serving shape (57,344 nodes, 9M edges, H = 64): the
// function needs the 1,342 nonzero 128x128 blocks. f32: 88 MB of blocks, x
// and out 14.7 MB each, about 117 MB, 35 us at 3.35 TB/s, against 8.4
// GFLOP of 3xTF32 products, 17 us at 495 TFLOP/s: bytes. int8 blocks with
// bf16 x: 22 MB + 7.3 MB + 14.7 MB, 13 us, against 2.8 us of bf16
// tensor-core products: bytes.

#include "spmm_common.cuh"

namespace {

using spmm::BLOCK;
using spmm::RING;
using spmm::TK;
using spmm::TN;
using spmm::THREADS;
constexpr int CHUNK = 8;               // blocks per stored wide chunk
constexpr int KW = CHUNK * BLOCK;      // values in one row of a stored chunk

// ------------------------------------------------------- f32: 3xTF32

template <typename X, bool XA>
__global__ void __launch_bounds__(THREADS, 2)
bcsr_tf32_kernel(const float* __restrict__ blocks,
                 const int* __restrict__ block_col,
                 const int* __restrict__ ptr, const int* __restrict__ end,
                 const X* __restrict__ x, float* __restrict__ out,
                 int n_x_rows, int n_out_rows, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  spmm::Tf32Stage* ring = reinterpret_cast<spmm::Tf32Stage*>(smem);

  const int n_rb = (n_out_rows + BLOCK - 1) / BLOCK;
  const int h0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  // this thread's A pieces: offset in a stored block's stage, and in a slot
  const int a_src = (tid / (TK / 4)) * KW + 4 * (tid % (TK / 4));
  const int a_dst = (tid / (TK / 4)) * spmm::A_LD + 4 * (tid % (TK / 4));

  // The load cursor runs RING - 1 stages ahead of the products along this
  // CTA's (row block, live block, 32-deep stage) sequence: row block l_rb,
  // block l_b of its live run [.., l_e), stage l_k; l_rb >= n_rb when done.
  int l_rb = blockIdx.x - gridDim.x, l_b = 0, l_e = 0, l_k = 0, l_i = 0;
  auto seek = [&]() {  // the next row block with a live block
    do {
      l_rb += gridDim.x;
      if (l_rb >= n_rb) return;
      l_b = ptr[l_rb];
      l_e = end[l_rb];
    } while (l_b == l_e);
  };
  auto load = [&]() {  // the next stage into slot l_i % RING, one group
    if (l_rb < n_rb) {
      spmm::Tf32Stage& st = ring[l_i % RING];
      const float* a = blocks + static_cast<long long>(l_b / CHUNK) * BLOCK * KW +
                       (l_b % CHUNK) * BLOCK + l_k;
      spmm::tf32_load_a(st, a + a_src, a_dst, KW);
      spmm::tf32_load_x<X, XA>(
          st, x, static_cast<long long>(block_col[l_b]) * BLOCK + l_k,
          n_x_rows, h, h0);
      l_k += TK;
      if (l_k == BLOCK) {
        l_k = 0;
        if (++l_b == l_e) seek();
      }
    }
    ++l_i;
    spmm::cp_async_commit();  // one group per stage, empty ones too
  };

  seek();
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) load();
  int s = 0;
  for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
    const int n_stages = (end[rb] - ptr[rb]) * (BLOCK / TK);
    spmm::MmaTile t;
    spmm::zero(t);
    for (int k = 0; k < n_stages; ++k, ++s) {
      spmm::cp_async_wait<RING - 2>();  // this thread's copies of stage s
      __syncthreads();  // everyone's; and slot (s - 1) % RING is free
      load();           // stage s + RING - 1
      spmm::tf32_compute(ring[s % RING], t);
    }
    const long long row0 = static_cast<long long>(rb) * BLOCK;
    spmm::for_each(t, [&](int r, int c, float v) {
      const long long row = row0 + r;
      const int col = h0 + c;
      if (row < n_out_rows && col < h) out[row * h + col] = v;
    });
  }
}

// ------------------------------------------- bf16 and int8: TMA + wgmma

struct BcsrWalk {
  const int* ptr;
  const int* end;
  const int* col;
  __device__ spmm::tc::Run run(int rb) const {
    const int lo = ptr[rb];
    return {rb, lo, end[rb] - lo, 0};
  }
  __device__ spmm::tc::Pair pair(const spmm::tc::Run& r, int t) const {
    const int b = r.lo + t;
    return {(b % CHUNK) * BLOCK, (b / CHUNK) * BLOCK, col[b] * BLOCK};
  }
};

template <typename S, typename X>
int launch(const void* blocks, int n_store, const int* block_col,
           const int* ptr, const int* end, const float* row_scale,
           const void* x, int x_ld, float* out, int n_x_rows, int n_out_rows,
           int h, cudaStream_t stream) {
  if constexpr (std::is_same<S, float>::value) {
    const int n_rb = (n_out_rows + BLOCK - 1) / BLOCK;
    const int col_tiles = (h + TN - 1) / TN;
    const int ctas = 2 * spmm::sm_count() / col_tiles;  // 2 CTAs an SM
    const dim3 grid(ctas < 1 ? 1 : (ctas < n_rb ? ctas : n_rb), col_tiles);
    const bool xa = std::is_same<X, float>::value && h % 4 == 0 &&
                    n_x_rows > 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    auto kernel = xa ? bcsr_tf32_kernel<X, true> : bcsr_tf32_kernel<X, false>;
    const cudaError_t err = spmm::allow_smem(
        reinterpret_cast<const void*>(kernel), spmm::TF32_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, THREADS, spmm::TF32_SMEM, stream>>>(
        static_cast<const float*>(blocks), block_col, ptr, end,
        static_cast<const X*>(x), out, n_x_rows, n_out_rows, h);
    return static_cast<int>(cudaGetLastError());
  } else if constexpr (std::is_same<X, uint16_t>::value) {
    return spmm::tc::launch<S>(blocks, static_cast<long long>(n_store) * BLOCK,
                               KW, x, n_x_rows, x_ld,
                               BcsrWalk{ptr, end, block_col}, row_scale, out,
                               n_out_rows, h, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper rounds x
  }
}

template <typename S>
int launch_x(int x_dtype, const void* blocks, int n_store,
             const int* block_col, const int* ptr, const int* end,
             const float* row_scale, const void* x, int x_ld, float* out,
             int n_x_rows, int n_out_rows, int h, cudaStream_t stream) {
  if (x_dtype == spmm::DT_F32)
    return launch<S, float>(blocks, n_store, block_col, ptr, end, row_scale,
                            x, x_ld, out, n_x_rows, n_out_rows, h, stream);
  if (x_dtype == spmm::DT_BF16)
    return launch<S, uint16_t>(blocks, n_store, block_col, ptr, end,
                               row_scale, x, x_ld, out, n_x_rows, n_out_rows,
                               h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (n_out_rows, h) and checks every shape. x: f32 or
// bf16 (n_x_rows, h) for f32 blocks; for bf16 and int8 blocks bf16 with row
// stride x_ld (a multiple of 8, >= h) and n_x_rows >= 1.
extern "C" int glass_bcsr_spmm(const void* blocks, int block_dtype,
                               int n_store, const int* block_col,
                               const int* block_row_ptr,
                               const int* block_row_end,
                               const float* row_scale, const void* x,
                               int x_dtype, int x_ld, float* out,
                               int n_x_rows, int n_out_rows, int h,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_dtype == spmm::DT_F32)
    return launch_x<float>(x_dtype, blocks, n_store, block_col, block_row_ptr,
                           block_row_end, row_scale, x, x_ld, out, n_x_rows,
                           n_out_rows, h, s);
  if (block_dtype == spmm::DT_BF16)
    return launch_x<uint16_t>(x_dtype, blocks, n_store, block_col,
                              block_row_ptr, block_row_end, row_scale, x,
                              x_ld, out, n_x_rows, n_out_rows, h, s);
  if (block_dtype == spmm::DT_I8)
    return launch_x<int8_t>(x_dtype, blocks, n_store, block_col,
                            block_row_ptr, block_row_end, row_scale, x, x_ld,
                            out, n_x_rows, n_out_rows, h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

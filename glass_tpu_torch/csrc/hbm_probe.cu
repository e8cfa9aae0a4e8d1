// HBM read-bandwidth probe for Hopper (sm_90a): streams a large f32 array
// from device memory through shared memory with the copy engine, as the
// TPU probe streams it into VMEM with its DMA engine.
//
// Replaces the two Pallas TPU bodies of tools/hbm_probe.py:
//   _read_kernel  (:89)   x (rows, 512) f32 read in chunks of chunk_rows
//                         rows, each chunk as S stripe copies of
//                         chunk_rows/S rows, double-buffered, `iters` passes;
//                         out[8i:8i+8] = x[i*chunk_rows : +8, :128]
//   _read2_kernel (:164)  the same, stripe s of chunk i read from array s:
//                         rows [i*chunk_rows/S, +chunk_rows/S) of xs[s];
//                         out[8i:8i+8] = xs[0][i*chunk_rows/S : +8, :128]
// Both are one kernel here: stripe s of chunk i starts at row
// i*chunk_stride_rows of base[s] (read: base[s] = x + s*chunk_rows/S rows,
// stride chunk_rows; read2: base[s] = xs[s], stride chunk_rows/S).
//
// Design. The TPU's DMA with a semaphore per stripe becomes a 1-D bulk copy
// (cp.async.bulk, the copy engine behind TMA) completing on its own
// mbarrier, so S copies are in flight per tile, and a ring of NBUF = 2
// tiles: the next tile is issued before the current one is waited on, as
// the TPU kernel prefetches chunk i+1. A 4 MiB TPU chunk does not fit an
// SM's shared memory, so each chunk is cut across persistent CTAs: CTA c
// holds rows [c*q, c*q + q) of every stripe of every chunk (the last CTA
// fewer), and walks the (pass, chunk) sequence. The CTA that holds rows
// 0-7 of stripe 0 (q < 8: the CTAs that do) writes lanes 0-127 of them to
// out, the TPU kernel's touch of its buffer. Copies move whole 2 KiB rows
// between 16-byte-aligned addresses.
//
// Bound on this card: the bytes read, at 3.35 TB/s (a 512 MiB pass:
// 160 us). Nothing is computed; out is 8*128 floats per chunk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 512;              // f32 values per row
constexpr int ROW_BYTES = LANES * 4;    // 2 KiB
constexpr int NBUF = 2;
constexpr int MAX_STRIPES = 8;
constexpr int OUT_ROWS = 8;
constexpr int OUT_LANES = 128;
constexpr int THREADS = 128;

struct Sources {
  const float* base[MAX_STRIPES];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// global -> shared bulk copy of `bytes`, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__global__ void __launch_bounds__(THREADS)
hbm_read_kernel(Sources src, float* __restrict__ out, int stripes,
                long long chunk_stride_rows, int rows_s, int q, int n_steps,
                int iters) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lo = blockIdx.x * q;               // this CTA's rows of a stripe
  const int len = min(q, rows_s - lo);
  if (len <= 0) return;                        // the whole CTA, together
  const long long tile_values = static_cast<long long>(stripes) * q * LANES;
  float* tiles = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + NBUF * tile_values * 4);
  const uint32_t stripe_bytes = static_cast<uint32_t>(len) * ROW_BYTES;
  const int tid = threadIdx.x;
  const long long total = static_cast<long long>(iters) * n_steps;

  if (tid == 0) {
    for (int i = 0; i < NBUF * stripes; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](long long t) {  // thread 0: tile t into its slot
    const int slot = static_cast<int>(t & 1);
    const long long chunk = t % n_steps;
    float* dst = tiles + slot * tile_values;
    for (int s = 0; s < stripes; ++s) {
      uint64_t* bar = &bars[slot * stripes + s];
      mbar_expect_tx(bar, stripe_bytes);
      bulk_copy(dst + static_cast<long long>(s) * q * LANES,
                src.base[s] + (chunk * chunk_stride_rows + lo) * LANES,
                stripe_bytes, bar);
    }
  };

  if (tid == 0) issue(0);
  const int out_rows = lo < OUT_ROWS ? min(OUT_ROWS, lo + len) - lo : 0;
  for (long long t = 0; t < total; ++t) {
    const int slot = static_cast<int>(t & 1);
    if (tid == 0 && t + 1 < total) {
      // the other slot's reads ended at the last __syncthreads; order them
      // before the copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(t + 1);
    }
    const uint32_t parity = static_cast<uint32_t>((t >> 1) & 1);
    for (int s = 0; s < stripes; ++s)
      while (!mbar_try_wait(&bars[slot * stripes + s], parity)) {
      }
    if (out_rows > 0) {  // stripe 0's rows sit first in the tile
      const float* tile = tiles + slot * tile_values;
      const long long chunk = t % n_steps;
      for (int e = tid; e < out_rows * OUT_LANES; e += THREADS) {
        const int r = e / OUT_LANES;
        const int l = e % OUT_LANES;
        out[(chunk * OUT_ROWS + lo + r) * OUT_LANES + l] = tile[r * LANES + l];
      }
    }
    __syncthreads();  // every thread is done with this slot and its phase
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success). The
// caller checks every shape: 1 <= stripes <= 8, rows_s >= 8, n_steps even,
// each base 16-byte aligned, stripes * q rows per tile within the shared
// memory it passes as smem_bytes (NBUF tiles and NBUF * stripes barriers)
// and q * 2 KiB under the mbarrier's 1 MiB transaction limit; out holds
// n_steps * 8 * 128 floats.
extern "C" int glass_hbm_read(const void* const* bases, int stripes,
                              long long chunk_stride_rows, int rows_s, int q,
                              int n_steps, int iters, float* out, int ctas,
                              int smem_bytes, void* stream) {
  if (stripes < 1 || stripes > MAX_STRIPES || q < 1 || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Sources src{};
  for (int s = 0; s < stripes; ++s)
    src.base[s] = static_cast<const float*>(bases[s]);
  cudaError_t err = cudaFuncSetAttribute(
      hbm_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  hbm_read_kernel<<<ctas, THREADS, smem_bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      src, out, stripes, chunk_stride_rows, rows_s, q, n_steps, iters);
  return static_cast<int>(cudaGetLastError());
}

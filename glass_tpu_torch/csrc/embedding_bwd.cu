// The embedding table's gradient in a fixed order, for Hopper (sm_90a):
// grad[k] = sum of g[r] over the rows r whose id is k, summed in an order
// that depends on the ids alone, so every run gives the same bits.
//
// Replaces no TPU kernel. The JAX package's gradient of the table lookup
// is XLA's scatter-add, which does not vary from run to run; PyTorch's
// CUDA backward of nn.Embedding sums in an order that does (the em_user
// step spread by 8.39e-5 over its 57,344 degree ids). This kernel is the
// port's counterpart of that scatter-add.
//
// The order (ops/embedding.py::embedding_order, built once per id vector):
// perm, a stable argsort of the ids; sorted_ids = ids[perm]; the sorted
// rows cut into chunks of `chunk` rows; a partial per (chunk, run of one
// id inside it), numbered in sorted order, so chunk c's partials start at
// part_start[c] and id k's partials are [id_part[k], id_part[k + 1]).
//
// Two launches, no atomics on the data:
//   1. chunk_kernel: thread (chunk, column) walks the chunk's rows in
//      sorted order, gathers g[perm[r], column] and adds it to its run's
//      sum (the first row's value, then one f32 add a row), writing the
//      sum into the run's partial when the id changes and at the end;
//   2. id_kernel: thread (id, column) adds its id's partials in chunk
//      order, from 0, and writes the table's row (f32).
// Both loops issue UNROLL loads before their adds, in order. The chunk
// pass is bound by the latency of its dependent loads (perm[r], then g's
// row) where its (chunk, column) threads are few (em_user: 224 x 64) and
// by bytes where they are many (the ladder's 40x: 8,960 x 64): 32 rows in
// flight a thread took em_user from 52 to 43 us cold but 40x from 307 to
// 384 (its registers cost occupancy), so 8.
//
// Bound on this card: bytes. g is read once (n_rows x h at its itemsize),
// the order once (perm and sorted_ids, 8 bytes a row), the table's
// gradient written once (n_ids x h f32): em_user, 57,344 x 64 f32, 14.7 MB
// of g, 4.4 us at 3.35 TB/s. The partials are a chunk'th of g (plus one a
// run boundary): at em_user a 256th.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;  // loads in flight a thread, both passes
constexpr int MAX_BLOCKS = 1 << 20;

// The card's own count of this library's launches: slot 0 the chunk pass,
// slot 1 the id pass. Thread 0 of CTA 0 of every launch adds one before
// anything else, so a replayed CUDA graph counts each launch it runs (the
// host wrapper counts a call, once at capture). glass_launches reads them.
__device__ unsigned long long g_launches[2];

__device__ __forceinline__ void count_launch(int slot) {
  if ((blockIdx.x | threadIdx.x) == 0) atomicAdd(&g_launches[slot], 1ULL);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {  // bf16 bits, exact
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const T* __restrict__ g, const int* __restrict__ perm,
             const int* __restrict__ sorted_ids,
             const int* __restrict__ part_start,
             float* __restrict__ partials, int n_rows, int chunk,
             int n_chunks, int h) {
  count_launch(0);
  const long long total = static_cast<long long>(n_chunks) * h;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long t = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       t < total; t += stride) {
    const int c = static_cast<int>(t / h);
    const int col = static_cast<int>(t - static_cast<long long>(c) * h);
    const long long lo = static_cast<long long>(c) * chunk;
    const long long hi = min(lo + chunk, static_cast<long long>(n_rows));
    long long slot = static_cast<long long>(part_start[c]) - 1;
    int cur = -1;
    float acc = 0.0f;
    for (long long base = lo; base < hi; base += UNROLL) {
      float v[UNROLL];
      int id[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long r = base + u;
        id[u] = -1;
        v[u] = 0.0f;
        if (r < hi) {
          id[u] = sorted_ids[r];
          v[u] = widen(g[static_cast<long long>(perm[r]) * h + col]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (id[u] < 0) continue;
        if (id[u] != cur) {
          if (cur >= 0) partials[slot * h + col] = acc;
          ++slot;
          cur = id[u];
          acc = v[u];
        } else {
          acc = __fadd_rn(acc, v[u]);
        }
      }
    }
    if (cur >= 0) partials[slot * h + col] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
id_kernel(const float* __restrict__ partials, const int* __restrict__ id_part,
          float* __restrict__ out, int n_ids, int h) {
  count_launch(1);
  const long long total = static_cast<long long>(n_ids) * h;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long t = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       t < total; t += stride) {
    const int k = static_cast<int>(t / h);
    const int col = static_cast<int>(t - static_cast<long long>(k) * h);
    const long long end = id_part[k + 1];
    long long p = id_part[k];
    float acc = 0.0f;
    for (; p + UNROLL <= end; p += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = partials[(p + u) * h + col];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; p < end; ++p) acc = __fadd_rn(acc, partials[p * h + col]);
    out[t] = acc;
  }
}

int blocks_for(long long total) {
  const long long b = (total + THREADS - 1) / THREADS;
  return static_cast<int>(b < MAX_BLOCKS ? (b > 0 ? b : 1) : MAX_BLOCKS);
}

}  // namespace

// Launches both passes on `stream` and returns the CUDA error code (0 on
// success). g is (n_rows, h) contiguous, f32 (g_bf16 == 0) or bf16 bits;
// perm and sorted_ids (n_rows,) int32; part_start (n_chunks + 1,) and
// id_part (n_ids + 1,) int32; partials (id_part[n_ids], h) f32 and out
// (n_ids, h) f32. The caller checks every shape; n_rows >= 1.
extern "C" int glass_embedding_bwd(const void* g, int g_bf16, const int* perm,
                                   const int* sorted_ids,
                                   const int* part_start, const int* id_part,
                                   float* partials, float* out, int n_rows,
                                   int chunk, int n_chunks, int n_ids, int h,
                                   void* stream) {
  if (n_rows < 1 || chunk < 1 || n_chunks < 1 || n_ids < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b1 = blocks_for(static_cast<long long>(n_chunks) * h);
  if (g_bf16)
    chunk_kernel<uint16_t><<<b1, THREADS, 0, st>>>(
        static_cast<const uint16_t*>(g), perm, sorted_ids, part_start,
        partials, n_rows, chunk, n_chunks, h);
  else
    chunk_kernel<float><<<b1, THREADS, 0, st>>>(
        static_cast<const float*>(g), perm, sorted_ids, part_start, partials,
        n_rows, chunk, n_chunks, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  id_kernel<<<blocks_for(static_cast<long long>(n_ids) * h), THREADS, 0,
              st>>>(partials, id_part, out, n_ids, h);
  return static_cast<int>(cudaGetLastError());
}

// The launches of the two passes since the last reset (count_launch's
// slots), zeroed when reset is non-zero; the CUDA error code. Synchronous.
extern "C" int glass_launches(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[2] = {};
    e = cudaMemcpyToSymbol(g_launches, zero, sizeof(g_launches));
  }
  return static_cast<int>(e);
}

// Fused whole-graph GraphNorm passes for Hopper (sm_90a), f32 or bf16 x.
//
// Replaces the five Pallas TPU bodies of glass_tpu/ops/pallas_norm.py:
//   K1 _colsum_kernel     (:61)   S1 = sum_n x                  (1, F) f32
//   K2 _varsum_kernel     (:71)   S2 = sum_n (x - am)^2         (1, F) f32
//   K3 _affine_kernel     (:86)   y  = x*g + h                  (N, F) x's type
//   K4 _bwd_reduce_kernel (:92)   R1 = sum_n dy,
//                                 R2 = sum_n dy*(x - am)        2 x (1, F) f32
//   K5 _bwd_dx_kernel     (:106)  dx = dy*a + x*c2 + c1         (N, F) x's type
// Each reduction also finishes the per-feature algebra that the JAX wrapper
// runs in jnp between its kernels (pallas_norm.py:155-160, :172-207), so
// that the per-feature vectors K2, K3 and K5 take come out of K1, K2 and
// K4 themselves:
//   K1 -> S1, mu = S1/N, am = mean_scale*mu
//   K2 -> S2, var = S2/N, g = w*s, h = b - g*mean_scale*mu,
//         s = rsqrt(var + eps)
//   K4 -> R1, R2, a = w*s, c2 = -(w*s^3/N)*R2,
//         c1 = -(w*mean_scale*s/N)*R1 - c2*(mean_scale*mu + mean_scale*mo),
//         dw = s*R2, db = R1, dalpha = -w*mu*s*R1 + w*mu*mo*s^3*R2,
//         mo = mu*(1 - mean_scale)
//
// Numerics. x and dy are read as stored (f32, or bf16 widened exactly) and
// every sum is taken in f32. The per-feature algebra and K3 and K5 multiply,
// divide and add in f32 with one rounding per operation, in the JAX
// expression's order (no contraction into FMA: __fmul_rn, __fadd_rn,
// __fdiv_rn; s^3 is s*(s*s) as jnp's integer power takes it; s is rsqrtf,
// the CUDA library's rsqrt that torch.rsqrt also takes on the card, within
// 2 ulp of the exact value), and K3 and K5 round their result once to x's
// type, to nearest even as .astype does.
//
// Design. The TPU's sequential grid over 1024-row panels, which carried the
// column sums in its output block, becomes independent CTAs that load 16
// bytes at a time (4 f32 or 8 bf16 values; one value where a pointer is
// not 16-byte aligned, or, for a reduction, where F is not a multiple of
// that). The JAX wrapper pads rows to 1024 and columns to 128 and masks
// the padded rows; here every row and column is bound-checked instead, so
// nothing is padded or copied.
//   Reductions (K1, K2, K4): one launch. A CTA of RED_THREADS threads owns
//   the column groups of one column tile (all of F up to RED_THREADS
//   groups) and walks row tiles of RED_THREADS / groups rows grid-stride
//   (tile blockIdx.x, + P, + 2P, ...), each thread keeping U tiles' 16-byte
//   loads (256 bytes) in flight before it adds them, with the streaming
//   hint (evict-first: a pass reads its rows once). P is the SM count (one
//   CTA an SM, all resident in one wave: the wrapper's ops/fused_norm.py
//   reduce_grid), or the number of row tiles if that is smaller. The CTA
//   adds its threads' sums in a fixed order through shared memory and
//   writes one partial (1, F) row per output to a workspace, then takes a
//   ticket (an acquire-release add on a counter in the workspace). The CTA
//   that draws the last ticket adds the partials of every CTA in a fixed
//   order (a strided sum per slice of rows, then the slices in order),
//   computes the per-feature algebra above (its vectors loaded before the
//   partials, and brought into L2 by CTA 0 while the rows stream) and
//   writes every output; it resets the counter to 0, so the next call, or
//   a replay of a captured graph, finds it zeroed with no memset. No float
//   atomics, so a repeated call is bit-identical. The wrapper keeps the
//   workspace per device and stream.
//   Elementwise (K3, K5): persistent CTAs, EW_CTAS_PER_SM an SM in one
//   wave, walk the contiguous (N, F) operands as one flat stream of
//   16-byte chunks (rows play no part: at F = 17 no lane idles and every
//   load is 16 bytes). Thread t takes chunks t, t + L, t + 2L, ..., where
//   the wrapper (ops/fused_norm.py elementwise_plan) makes L, the walking
//   threads, a multiple of the column period F / gcd(F, V): every chunk a
//   thread takes starts at the same column, so the thread loads its V
//   columns of g, h (or a, c2, c1) once into registers, whatever row
//   boundaries its chunks cross. Each thread issues 8 16-byte loads (K3: 8
//   chunks of x; K5: 4 of dy and 4 of x) before its first store. K5 loads
//   with the evict-first hint (its operands' last read); K3 with the
//   default policy, since K4 reads x again: with the hint, K3's own stores
//   evict x, and a norm's forward + backward took 4-5 us more on the card
//   (PERF.md section 6). y and dx are stored with the default policy,
//   since the next op reads them. The wrapper passes every argument in
//   one packed struct: the host's work per call is of the pass's own size.
//
// Bounds on this card at em_user (N = 57,344, F = 64; x f32 is 14.68 MB):
// every pass moves bytes only (at most 4 flops per element, far under the
// f32 rate), so each is bound by bytes at 3.35 TB/s: K1 and K2 one read of
// x (4.38 us f32, 2.19 us bf16), K3 one read and one write (8.76 / 4.38),
// K4 two reads (8.76 / 4.38), K5 two reads and one write (13.15 / 6.57).
// The partials (P x F f32 per output, P <= the SM count) stay in L2 and add
// under 1 % of the bytes. What the bytes leave out is a reduction's fixed
// cost: the launch and its first loads, the CTA's sum, the ticket and the
// last CTA's finish, a chain of round trips to L2 that no CTA overlaps;
// tools/torch_kernel_variants.py times the streaming loop alone
// (-DGLASS_NORM_STREAM_ONLY) beside the whole kernel, and K3 and K5 beside
// torch's own elementwise stream (copy_) and an empty kernel (PERF.md
// section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int EW_THREADS = 256;    // K3, K5 (ops/fused_norm.py EW_THREADS)
constexpr int EW_CTAS_PER_SM = 2;  // (ops/fused_norm.py EW_CTAS_PER_SM)
constexpr int RED_THREADS = 512;   // K1, K2, K4 (ops/fused_norm.py RED_THREADS)
constexpr int FINISH_BATCH = 16;   // loads in flight per thread in a fixed-order sum
constexpr int DT_F32 = 0;   // ops/fused_norm.py DTYPE_CODES
constexpr int DT_BF16 = 1;
constexpr int RED_SUM = 0;  // K1
constexpr int RED_VAR = 1;  // K2
constexpr int RED_BWD = 2;  // K4
constexpr int EW_AFFINE = 0;  // K3
constexpr int EW_DX = 1;      // K5

// The card's own count of launches, slot dtype * 5 + pass (K1, K2, K4 as
// RED_SUM, RED_VAR, RED_BWD, then K3, K5): thread 0 of CTA 0 of every
// launch adds one before anything else, so a replayed CUDA graph counts
// each pass it runs. glass_launches reads them.
__device__ unsigned long long g_launches[10];

template <typename T>
__device__ __forceinline__ void count_launch(int pass) {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y |
       threadIdx.z) == 0)
    atomicAdd(&g_launches[(sizeof(T) == 4 ? DT_F32 : DT_BF16) * 5 + pass],
              1ULL);
}
// the workspace: the ticket counter, then the partials from this byte on
// (ops/fused_norm.py PARTIALS_OFFSET)
constexpr int PARTIALS_OFFSET = 256;

__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// f32 -> bf16 bits, round to nearest even (a NaN stays a quiet NaN)
__device__ __forceinline__ uint16_t bf16_rne(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return static_cast<uint16_t>((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(uint16_t* p, float v) { *p = bf16_rne(v); }

// V consecutive values of row-major storage as one load: float4 (4 f32),
// uint4 (8 bf16) or the scalar itself. V > 1 only where the address is
// 16-byte aligned and the V values lie in one row.
template <typename T, int V> struct Raw { using type = T; };
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<uint16_t, 8> { using type = uint4; };

template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type fetch(const T* p) {
  return __ldg(reinterpret_cast<const typename Raw<T, V>::type*>(p));
}

// the same load with the streaming hint (ld.global.cs: evict-first in L1
// and L2), for operands a pass reads once
template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type fetch_once(const T* p) {
  return __ldcs(reinterpret_cast<const typename Raw<T, V>::type*>(p));
}

__device__ __forceinline__ void unpack(float q, float (&v)[1]) { v[0] = q; }
__device__ __forceinline__ void unpack(uint16_t q, float (&v)[1]) { v[0] = widen(q); }
__device__ __forceinline__ void unpack(float4 q, float (&v)[4]) {
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void unpack(uint4 q, float (&v)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);          // low half first
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  unpack(fetch<T, V>(p), v);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    narrow(p, v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = static_cast<uint32_t>(bf16_rne(v[2 * j]))
             | (static_cast<uint32_t>(bf16_rne(v[2 * j + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The per-feature inputs of the reductions and their finishes; a pointer a
// mode does not read is null.
struct Vecs {
  const float* am;   // K2, K4: the centre mean_scale*mu
  const float* mu;   // K2, K4
  const float* var;  // K4
  const float* ms;   // mean_scale: K1, K2, K4
  const float* w;    // weight: K2, K4
  const float* b;    // bias: K2
  float eps;         // K2, K4
};

// One column's inputs of a finish (those its mode reads).
struct Fin {
  float ms, w, b, mu, var;
};

template <int MODE>
__device__ __forceinline__ Fin fin_inputs(const Vecs& v, int c) {
  Fin in{};
  in.ms = v.ms[c];
  if constexpr (MODE != RED_SUM) {
    in.w = v.w[c];
    in.mu = v.mu[c];
  }
  if constexpr (MODE == RED_VAR) in.b = v.b[c];
  if constexpr (MODE == RED_BWD) in.var = v.var[c];
  return in;
}

// Brings the finish's vectors into L2 (one prefetch per 128-byte line) while
// the rows stream, so that the last CTA finds them there.
__device__ __forceinline__ void prefetch_l2(const Vecs& v, int f) {
  const float* vecs[5] = {v.ms, v.w, v.b, v.mu, v.var};
  for (int c = threadIdx.x * 32; c < f; c += RED_THREADS * 32)
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (vecs[k] != nullptr) asm volatile("prefetch.L2 [%0];" ::"l"(vecs[k] + c));
}

// The outputs of each reduction, rows of `out` (n_out_rows x f):
//   K1: S1, mu, am
//   K2: S2, var, g, h
//   K4: R1, R2, a, c2, c1, dw, db, dalpha
template <int MODE>
__device__ __forceinline__ void finish_column(int c, const float* s,
                                              const Fin& in, float eps,
                                              float nf, float* __restrict__ out,
                                              int f) {
  if constexpr (MODE == RED_SUM) {
    const float mu = __fdiv_rn(s[0], nf);
    out[c] = s[0];
    out[f + c] = mu;
    out[2 * f + c] = __fmul_rn(in.ms, mu);
  } else if constexpr (MODE == RED_VAR) {
    const float var = __fdiv_rn(s[0], nf);
    const float sd = rsqrtf(__fadd_rn(var, eps));
    const float g = __fmul_rn(in.w, sd);
    out[c] = s[0];
    out[f + c] = var;
    out[2 * f + c] = g;
    out[3 * f + c] = __fsub_rn(in.b, __fmul_rn(__fmul_rn(g, in.ms), in.mu));
  } else {
    const float r1 = s[0], r2 = s[1];
    const float w = in.w, ms = in.ms, mu = in.mu;
    const float sd = rsqrtf(__fadd_rn(in.var, eps));
    const float s3 = __fmul_rn(sd, __fmul_rn(sd, sd));
    const float mo = __fmul_rn(mu, __fsub_rn(1.f, ms));
    const float c2 = __fmul_rn(-__fdiv_rn(__fmul_rn(w, s3), nf), r2);
    const float c1 = __fsub_rn(
        __fmul_rn(-__fdiv_rn(__fmul_rn(__fmul_rn(w, ms), sd), nf), r1),
        __fmul_rn(c2, __fadd_rn(__fmul_rn(ms, mu), __fmul_rn(ms, mo))));
    const float dalpha = __fadd_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(-w, mu), sd), r1),
        __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(w, mu), mo), s3), r2));
    out[c] = r1;
    out[f + c] = r2;
    out[2 * f + c] = __fmul_rn(w, sd);
    out[3 * f + c] = c2;
    out[4 * f + c] = c1;
    out[5 * f + c] = __fmul_rn(sd, r2);
    out[6 * f + c] = r1;
    out[7 * f + c] = dalpha;
  }
}

// Calls done(c, s) once for every column c < cols, with s[o] = the sum over
// r < rows of load(o, r, c), o < NOUT, added in a fixed order: J =
// RED_THREADS / cols slices (at least 1), slice q adding rows q, q + J, ...
// in order (FINISH_BATCH loads in flight), then the slices in order q = 0,
// 1, ... through `scratch` (NOUT * RED_THREADS floats). Consecutive threads
// take consecutive columns, so loads of row-major rows coalesce. Every
// thread of the block calls it; it ends on a barrier.
template <int NOUT, typename Load, typename Done>
__device__ __forceinline__ void column_sums(int rows, int cols, float* scratch,
                                            Load load, Done done) {
  const int t = threadIdx.x;
  const int slices = max(1, RED_THREADS / cols);
  for (int e = t; e < slices * cols; e += RED_THREADS) {
    const int q = e / cols, c = e % cols;
    float s[NOUT];
#pragma unroll
    for (int o = 0; o < NOUT; ++o) s[o] = 0.f;
    for (int r0 = q; r0 < rows; r0 += FINISH_BATCH * slices) {
      float v[NOUT][FINISH_BATCH];
#pragma unroll
      for (int k = 0; k < FINISH_BATCH; ++k) {
        const int r = r0 + k * slices;
#pragma unroll
        for (int o = 0; o < NOUT; ++o) v[o][k] = r < rows ? load(o, r, c) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < FINISH_BATCH; ++k)
        if (r0 + k * slices < rows) {
#pragma unroll
          for (int o = 0; o < NOUT; ++o) s[o] += v[o][k];
        }
    }
    if (slices == 1) {
      done(c, s);
    } else {
#pragma unroll
      for (int o = 0; o < NOUT; ++o) scratch[o * RED_THREADS + e] = s[o];
    }
  }
  if (slices > 1) {
    __syncthreads();
    if (t < cols) {
      float s[NOUT];
#pragma unroll
      for (int o = 0; o < NOUT; ++o) s[o] = 0.f;
      for (int q = 0; q < slices; ++q)
#pragma unroll
        for (int o = 0; o < NOUT; ++o) s[o] += scratch[o * RED_THREADS + q * cols + t];
      done(t, s);
    }
  }
  __syncthreads();
}

// K1, K2, K4 in one launch, grid (P, column tiles), block RED_THREADS: each
// CTA sums its row tiles into partial[o, blockIdx.x, :] (its column tile),
// and the CTA that draws the last ticket adds the partials and finishes.
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(RED_THREADS, 1)
reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy, Vecs vec,
              float* __restrict__ out, unsigned int* __restrict__ ticket,
              float* __restrict__ partial, long long n, int f) {
  count_launch<T>(MODE);
  constexpr int NOUT = MODE == RED_BWD ? 2 : 1;
  // row tiles in flight per thread: 16 16-byte loads (16 of x, or 8 of x
  // and 8 of dy), every tile a CTA walks at em_user in one batch but K4's
  // f32 (two), within the 128 registers a thread of one CTA an SM has
  constexpr int U = V == 1 ? 8 : (MODE == RED_BWD ? 8 : 16);
  using R = typename Raw<T, V>::type;
  __shared__ float red[RED_THREADS * V];
  __shared__ float scratch[NOUT * RED_THREADS];
  __shared__ bool last;

  const int t = threadIdx.x;
  const int groups = (f + V - 1) / V;
  const int tile_groups = min(groups, RED_THREADS);
  const int slots = RED_THREADS / tile_groups;  // rows of a row tile
  const int slot = t / tile_groups;
  const int grp = blockIdx.y * tile_groups + t % tile_groups;
  const int c0 = grp * V;
  const bool live = slot < slots && grp < groups;
  const long long p = gridDim.x;
  const long long tiles = (n + slots - 1) / slots;

  float acc[NOUT][V];
  float amv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    acc[0][v] = 0.f;
    if constexpr (NOUT == 2) acc[1][v] = 0.f;
    amv[v] = (MODE != RED_SUM && live) ? vec.am[c0 + v] : 0.f;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0) prefetch_l2(vec, f);
  if (live) {
    for (long long k = blockIdx.x; k < tiles; k += U * p) {
      R xr[U], dr[U];
      bool in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // every load first, then the sums
        const long long r = (k + u * p) * slots + slot;
        in[u] = r < n;
        if (in[u]) {
          xr[u] = fetch_once<T, V>(x + r * f + c0);
          if constexpr (MODE == RED_BWD) dr[u] = fetch_once<T, V>(dy + r * f + c0);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!in[u]) continue;
        float xv[V];
        unpack(xr[u], xv);
        if constexpr (MODE == RED_SUM) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[0][v] += xv[v];
        } else if constexpr (MODE == RED_VAR) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float d = xv[v] - amv[v];
            acc[0][v] += d * d;
          }
        } else {
          float dv[V];
          unpack(dr[u], dv);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[0][v] += dv[v];
            acc[1][v] += dv[v] * (xv[v] - amv[v]);
          }
        }
      }
    }
  }

#ifdef GLASS_NORM_STREAM_ONLY
  // tools/torch_kernel_variants.py: the streaming loop alone, its sums kept
  // live by a store that no input reaches; no CTA sum, ticket or finish,
  // and the outputs are not written
  if (acc[0][0] == -1.2345e30f) partial[t] = acc[NOUT - 1][V - 1];
  return;
#endif
  // the CTA's sum of each output over its slots: red[slot][column of tile]
  const int width = tile_groups * V;
  const int col0 = blockIdx.y * width;
  const int cols = min(width, f - col0);
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    if (slot < slots) {
#pragma unroll
      for (int v = 0; v < V; ++v) red[t * V + v] = acc[o][v];
    }
    __syncthreads();
    float* dst = partial + (o * p + blockIdx.x) * f + col0;
    column_sums<1>(slots, cols, scratch,
                   [&](int, int r, int c) { return red[r * width + c]; },
                   [&](int c, const float* s) { dst[c] = s[0]; });
  }

  // the ticket, as cooperative groups' grid barrier takes it, after the
  // CTA's barrier, by one thread: an acquire-release add at GPU scope
  // releases the CTA's partials and, for the CTA that draws the last
  // ticket, acquires every CTA's; that CTA finishes every column
  if (t == 0) {
    unsigned int drawn;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(drawn) : "l"(ticket) : "memory");
    last = drawn == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  const Fin mine = t < f ? fin_inputs<MODE>(vec, t) : Fin{};  // before the sums
  const float nf = static_cast<float>(n);
  column_sums<NOUT>(
      static_cast<int>(p), f, scratch,
      [&](int o, int r, int c) { return __ldcg(partial + (o * p + r) * f + c); },
      [&](int c, const float* s) {
        finish_column<MODE>(c, s, c == t ? mine : fin_inputs<MODE>(vec, c),
                            vec.eps, nf, out, f);
      });
  if (t == 0) *ticket = 0u;  // ready for the next launch
}

// K3 (EW_AFFINE: out = x*g + h) and K5 (EW_DX: out = dy*a + x*c2 + c1)
// over the flat stream of x's n*f elements in chunks of V (16 bytes, or
// one value): thread t < live walks chunks t, t + live, t + 2*live, ...,
// U at a time with every load in flight before the first store. live is
// a multiple of the column period f / gcd(f, V), so every chunk a thread
// walks starts at the same column and the thread keeps its chunk's V
// columns of each vector in registers; a chunk may cross a row boundary
// (f not a multiple of V, or f < V). v0, v1, v2 are g, h (v2 unread) or
// a, c2, c1. The last chunk, partial where V does not divide n*f, is taken
// one value at a time by the thread whose walk reaches it. A thread at or
// past the chunks has nothing to do: the grid need cover only min(live,
// chunks) threads.
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(EW_THREADS, EW_CTAS_PER_SM)
elementwise_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ v0, const float* __restrict__ v1,
                   const float* __restrict__ v2, T* __restrict__ out,
                   long long total, int f, long long live) {
  count_launch<T>(3 + MODE);
  constexpr int U = MODE == EW_AFFINE ? 8 : 4;  // 8 16-byte loads a thread
  using R = typename Raw<T, V>::type;
  const long long t = static_cast<long long>(blockIdx.x) * EW_THREADS + threadIdx.x;
  if (t >= live) return;  // no barrier in this kernel
  float p0[V], p1[V], p2[V];
  int c = static_cast<int>(t * V % f);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p0[v] = v0[c];
    p1[v] = v1[c];
    p2[v] = MODE == EW_DX ? v2[c] : 0.f;
    c = c + 1 == f ? 0 : c + 1;
  }
  const auto apply = [&](int v, float xv, float dv) {
    return MODE == EW_AFFINE
               ? __fadd_rn(__fmul_rn(xv, p0[v]), p1[v])
               : __fadd_rn(__fadd_rn(__fmul_rn(dv, p0[v]), __fmul_rn(xv, p1[v])), p2[v]);
  };
  const long long full = total / V;  // whole chunks
  for (long long i0 = t; i0 < full; i0 += U * live) {
    R xr[U], dr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load first, then the stores
      const long long i = i0 + u * live;
      if (i < full) {  // K3's x stays in L2 for K4; K5 reads its last
        xr[u] = MODE == EW_AFFINE ? fetch<T, V>(x + i * V) : fetch_once<T, V>(x + i * V);
        if constexpr (MODE == EW_DX) dr[u] = fetch_once<T, V>(dy + i * V);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = i0 + u * live;
      if (i >= full) continue;
      float xv[V], dv[V], o[V];
      unpack(xr[u], xv);
      if constexpr (MODE == EW_DX) unpack(dr[u], dv);
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = apply(v, xv[v], MODE == EW_DX ? dv[v] : 0.f);
      store<T, V>(out + i * V, o);
    }
  }
  const int rest = static_cast<int>(total - full * V);
  if (rest > 0 && full % live == t) {
#pragma unroll
    for (int v = 0; v < V; ++v) {  // unrolled: p0..p2 stay in registers
      if (v < rest) {
        const long long e = full * V + v;
        float xv[1], dv[1] = {0.f};
        load<T, 1>(x + e, xv);
        if constexpr (MODE == EW_DX) load<T, 1>(dy + e, dv);
        narrow(out + e, apply(v, xv[0], dv[0]));
      }
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int V>
void reduce_t(int mode, dim3 grid, const void* x, const void* dy,
              const Vecs& vec, float* out, void* workspace, long long n,
              int f, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dy);
  unsigned int* ticket = static_cast<unsigned int*>(workspace);
  float* partial = reinterpret_cast<float*>(static_cast<char*>(workspace) + PARTIALS_OFFSET);
  if (mode == RED_SUM)
    reduce_kernel<T, V, RED_SUM><<<grid, RED_THREADS, 0, st>>>(xp, dp, vec, out, ticket, partial, n, f);
  else if (mode == RED_VAR)
    reduce_kernel<T, V, RED_VAR><<<grid, RED_THREADS, 0, st>>>(xp, dp, vec, out, ticket, partial, n, f);
  else
    reduce_kernel<T, V, RED_BWD><<<grid, RED_THREADS, 0, st>>>(xp, dp, vec, out, ticket, partial, n, f);
}

template <typename T, int V>
void elementwise_t(int mode, const T* x, const T* dy, const float* v0,
                   const float* v1, const float* v2, T* out, long long total,
                   int f, int ctas, long long live, cudaStream_t st) {
  if (mode == EW_AFFINE)
    elementwise_kernel<T, V, EW_AFFINE><<<ctas, EW_THREADS, 0, st>>>(x, dy, v0, v1, v2, out, total, f, live);
  else
    elementwise_kernel<T, V, EW_DX><<<ctas, EW_THREADS, 0, st>>>(x, dy, v0, v1, v2, out, total, f, live);
}

}  // namespace

// The launches of the five passes since the last reset (count_launch's
// slots), zeroed when reset is non-zero; the CUDA error code.
extern "C" int glass_launches(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[10] = {};
    e = cudaMemcpyToSymbol(g_launches, zero, sizeof(g_launches));
  }
  return static_cast<int>(e);
}

// The card's SM count (cudaDeviceGetAttribute), or -1 on an error: the
// reductions' P and the elementwise passes' grid (ops/fused_norm.py
// reduce_grid, elementwise_plan).
extern "C" int glass_norm_sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return sms;
}

// The arguments of each entry point, one 8-byte field each in this order
// (ops/fused_norm.py packs them with struct: one ctypes argument, not 12
// or 18, since these passes are short enough that the host's per-call
// cost shows beside them). Pointers are device addresses, 0 for none.
struct ReduceArgs {
  long long mode, x, dy, dtype, v, am, mu, var, ms, w, b;
  double eps;
  long long out, workspace, n, f, p, stream;
};

struct ElementwiseArgs {
  long long mode, dtype, v, x, dy, v0, v1, v2, out, total, f, ctas, live, stream;
};

template <typename P>
P* ptr(long long a) {
  return reinterpret_cast<P*>(static_cast<uintptr_t>(a));
}

// K1 (mode 0: x; ms), K2 (mode 1: x, am; mu, ms, w, b, eps) and K4 (mode 2:
// x, dy, am; mu, var, w, ms, eps), one launch of p x (column tiles) CTAs on
// `stream`: writes the mode's rows of `out` (3, 4 or 8 rows of f floats,
// finish_column), through `workspace` (a zeroed 32-bit counter at byte 0,
// which every launch leaves zeroed, and n_out * p * f floats of partials
// from byte PARTIALS_OFFSET; one workspace per stream). v is the values a
// thread loads at once: 1, or 4 (f32) / 8 (bf16) where f is a multiple of
// it and x and dy are 16-byte aligned. Returns cudaGetLastError() (0 on
// success). The caller checks shapes and types; n >= 0, f >= 1, p >= 1.
extern "C" int glass_norm_reduce(const ReduceArgs* a) {
  const cudaStream_t st = ptr<CUstream_st>(a->stream);
  const int mode = static_cast<int>(a->mode), dtype = static_cast<int>(a->dtype);
  const int v = static_cast<int>(a->v), f = static_cast<int>(a->f);
  const int p = static_cast<int>(a->p);
  const long long n = a->n;
  const void* x = ptr<const void>(a->x);
  const void* dy = ptr<const void>(a->dy);
  const int vmax = dtype == DT_F32 ? 4 : 8;
  if (n < 0 || f < 1 || p < 1 || mode < RED_SUM || mode > RED_BWD ||
      (dtype != DT_F32 && dtype != DT_BF16) ||
      (v != 1 && (v != vmax || f % v != 0 || !aligned16(x) || !aligned16(dy))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (f + v - 1) / v;
  const int tile_groups = groups < RED_THREADS ? groups : RED_THREADS;
  const dim3 grid(static_cast<unsigned>(p), (groups + tile_groups - 1) / tile_groups);
  const Vecs vec{ptr<const float>(a->am), ptr<const float>(a->mu),
                 ptr<const float>(a->var), ptr<const float>(a->ms),
                 ptr<const float>(a->w), ptr<const float>(a->b),
                 static_cast<float>(a->eps)};
  float* out = ptr<float>(a->out);
  void* ws = ptr<void>(a->workspace);
  if (dtype == DT_F32) {
    if (v == 4) reduce_t<float, 4>(mode, grid, x, dy, vec, out, ws, n, f, st);
    else reduce_t<float, 1>(mode, grid, x, dy, vec, out, ws, n, f, st);
  } else {
    if (v == 8) reduce_t<uint16_t, 8>(mode, grid, x, dy, vec, out, ws, n, f, st);
    else reduce_t<uint16_t, 1>(mode, grid, x, dy, vec, out, ws, n, f, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 (mode 0: out = x*g + h, v0 = g, v1 = h, v2 = 0) and K5 (mode 1: out =
// dy*a + x*c2 + c1, v0 = a, v1 = c2, v2 = c1), out of x's type and n*f =
// total values, one launch of ctas x EW_THREADS threads on `stream`, the
// first `live` of which walk (ops/fused_norm.py elementwise_plan): live a
// multiple of the column period f / gcd(f, v), and the grid covering
// min(live, ceil(total / v)) threads. v is 1, or 4 (f32) / 8 (bf16) where
// x, dy and out are 16-byte aligned. Returns cudaGetLastError() (0 on
// success). The caller checks shapes and types; total >= 1, f >= 1.
extern "C" int glass_norm_elementwise(const ElementwiseArgs* a) {
  const cudaStream_t st = ptr<CUstream_st>(a->stream);
  const int mode = static_cast<int>(a->mode), dtype = static_cast<int>(a->dtype);
  const int v = static_cast<int>(a->v), f = static_cast<int>(a->f);
  const int ctas = static_cast<int>(a->ctas);
  const long long total = a->total, live = a->live;
  const void* x = ptr<const void>(a->x);
  const void* dy = ptr<const void>(a->dy);
  void* out = ptr<void>(a->out);
  const float* v0 = ptr<const float>(a->v0);
  const float* v1 = ptr<const float>(a->v1);
  const float* v2 = ptr<const float>(a->v2);
  const int vmax = dtype == DT_F32 ? 4 : 8;
  if (total < 1 || f < 1 || ctas < 1 || live < 1 ||
      (mode != EW_AFFINE && mode != EW_DX) ||
      (dtype != DT_F32 && dtype != DT_BF16) ||
      (v != 1 && (v != vmax || !aligned16(x) || !aligned16(dy) || !aligned16(out))))
    return static_cast<int>(cudaErrorInvalidValue);
  int common = v;  // gcd(f, v): v is a power of two
  while (f % common != 0) common /= 2;
  const long long chunks = (total + v - 1) / v;
  if (live % (f / common) != 0 ||
      (live < chunks ? live : chunks) > static_cast<long long>(ctas) * EW_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32) {
    const float* xp = static_cast<const float*>(x);
    const float* dp = static_cast<const float*>(dy);
    float* op = static_cast<float*>(out);
    if (v == 4) elementwise_t<float, 4>(mode, xp, dp, v0, v1, v2, op, total, f, ctas, live, st);
    else elementwise_t<float, 1>(mode, xp, dp, v0, v1, v2, op, total, f, ctas, live, st);
  } else {
    const uint16_t* xp = static_cast<const uint16_t*>(x);
    const uint16_t* dp = static_cast<const uint16_t*>(dy);
    uint16_t* op = static_cast<uint16_t*>(out);
    if (v == 8) elementwise_t<uint16_t, 8>(mode, xp, dp, v0, v1, v2, op, total, f, ctas, live, st);
    else elementwise_t<uint16_t, 1>(mode, xp, dp, v0, v1, v2, op, total, f, ctas, live, st);
  }
  return static_cast<int>(cudaGetLastError());
}

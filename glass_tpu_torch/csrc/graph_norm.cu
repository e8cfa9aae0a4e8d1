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
// column sums in its output block, becomes independent CTAs. Threads map
// along the features with 16-byte vector loads (4 f32 or 8 bf16 values; one
// value when F is not a multiple of that or a pointer is not 16-byte
// aligned), and down the rows. The JAX wrapper pads rows to 1024 and
// columns to 128 and masks the padded rows; here every row and column is
// bound-checked instead, so nothing is padded or copied.
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
//   Elementwise (K3, K5): each thread keeps the per-feature vectors of its
//   column group in registers for all its rows (its columns never change),
//   then streams its rows.
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
// (-DGLASS_NORM_STREAM_ONLY) beside the whole kernel (PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // K3, K5
constexpr int RED_THREADS = 512;   // K1, K2, K4 (ops/fused_norm.py RED_THREADS)
constexpr int FINISH_BATCH = 16;   // loads in flight per thread in a fixed-order sum
constexpr int DT_F32 = 0;   // ops/fused_norm.py DTYPE_CODES
constexpr int DT_BF16 = 1;
constexpr int RED_SUM = 0;  // K1
constexpr int RED_VAR = 1;  // K2
constexpr int RED_BWD = 2;  // K4
constexpr int EW_AFFINE = 0;  // K3
constexpr int EW_DX = 1;      // K5
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

// K3 (v0 = g, v1 = h) and K5 (v0 = a, v1 = c2, v2 = c1) over rows [r0, r1).
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(THREADS)
rowwise_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ v0, const float* __restrict__ v1,
               const float* __restrict__ v2, T* __restrict__ out,
               long long n, int f, long long rows_per_cta) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= f) return;  // no barrier in this kernel
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long r1 = min(n, r0 + rows_per_cta);
  float p0[V], p1[V], p2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool in = c0 + v < f;
    p0[v] = in ? v0[c0 + v] : 0.f;
    p1[v] = in ? v1[c0 + v] : 0.f;
    p2[v] = (MODE == EW_DX && in) ? v2[c0 + v] : 0.f;
  }
#pragma unroll 4
  for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    float xv[V], o[V];
    load<T, V>(x + r * f + c0, xv);
    if constexpr (MODE == EW_AFFINE) {
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = __fadd_rn(__fmul_rn(xv[v], p0[v]), p1[v]);
    } else {
      float dv[V];
      load<T, V>(dy + r * f + c0, dv);
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = __fadd_rn(__fadd_rn(__fmul_rn(dv[v], p0[v]), __fmul_rn(xv[v], p1[v])),
                         p2[v]);
    }
    store<T, V>(out + r * f + c0, o);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// K3 and K5's launch shape: V values per thread, TX threads along the
// column groups (a power of two up to 32), TY = THREADS / TX down the rows,
// one CTA per (row range, column tile).
struct Shape {
  int v;
  dim3 block, grid;
};

Shape shape(int dtype, bool vec_ok, long long n, int f,
            long long rows_per_cta) {
  const int vmax = dtype == DT_F32 ? 4 : 8;
  const int v = (vec_ok && f % vmax == 0) ? vmax : 1;
  const int groups = (f + v - 1) / v;
  int tx = 1;
  while (tx < groups && tx < 32) tx *= 2;
  const long long p = (n + rows_per_cta - 1) / rows_per_cta;
  return Shape{v, dim3(tx, THREADS / tx),
               dim3(static_cast<unsigned>(p), (groups + tx - 1) / tx)};
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
void rowwise_t(int mode, const void* x, const void* dy, const float* v0,
               const float* v1, const float* v2, void* out, long long n, int f,
               long long rows, const Shape& s, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(out);
  if (mode == EW_AFFINE)
    rowwise_kernel<T, V, EW_AFFINE><<<s.grid, s.block, 0, st>>>(xp, dp, v0, v1, v2, op, n, f, rows);
  else
    rowwise_kernel<T, V, EW_DX><<<s.grid, s.block, 0, st>>>(xp, dp, v0, v1, v2, op, n, f, rows);
}

}  // namespace

// The card's SM count (cudaDeviceGetAttribute), or -1 on an error: the
// reductions' P (ops/fused_norm.py reduce_grid).
extern "C" int glass_norm_sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return sms;
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
extern "C" int glass_norm_reduce(int mode, const void* x, const void* dy,
                                 int dtype, int v, const float* am,
                                 const float* mu, const float* var,
                                 const float* ms, const float* w,
                                 const float* b, float eps, float* out,
                                 void* workspace, long long n, int f, int p,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vmax = dtype == DT_F32 ? 4 : 8;
  if (n < 0 || f < 1 || p < 1 || mode < RED_SUM || mode > RED_BWD ||
      (dtype != DT_F32 && dtype != DT_BF16) ||
      (v != 1 && (v != vmax || f % v != 0 || !aligned16(x) || !aligned16(dy))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (f + v - 1) / v;
  const int tile_groups = groups < RED_THREADS ? groups : RED_THREADS;
  const dim3 grid(static_cast<unsigned>(p), (groups + tile_groups - 1) / tile_groups);
  const Vecs vec{am, mu, var, ms, w, b, eps};
  if (dtype == DT_F32) {
    if (v == 4) reduce_t<float, 4>(mode, grid, x, dy, vec, out, workspace, n, f, st);
    else reduce_t<float, 1>(mode, grid, x, dy, vec, out, workspace, n, f, st);
  } else {
    if (v == 8) reduce_t<uint16_t, 8>(mode, grid, x, dy, vec, out, workspace, n, f, st);
    else reduce_t<uint16_t, 1>(mode, grid, x, dy, vec, out, workspace, n, f, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 (mode 0: out = x*v0 + v1) and K5 (mode 1: out = dy*v0 + x*v1 + v2),
// out (n, f) of x's type. One launch on `stream`; returns
// cudaGetLastError(). The caller checks shapes and types; n >= 1, f >= 1.
extern "C" int glass_norm_rowwise(int mode, const void* x, const void* dy,
                                  int dtype, const float* v0, const float* v1,
                                  const float* v2, void* out, long long n,
                                  int f, long long rows_per_cta, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || f < 1 || rows_per_cta < 1 || (mode != EW_AFFINE && mode != EW_DX) ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape(dtype, aligned16(x) && aligned16(dy) && aligned16(out),
                        n, f, rows_per_cta);
  if (dtype == DT_F32) {
    if (s.v == 4) rowwise_t<float, 4>(mode, x, dy, v0, v1, v2, out, n, f, rows_per_cta, s, st);
    else rowwise_t<float, 1>(mode, x, dy, v0, v1, v2, out, n, f, rows_per_cta, s, st);
  } else {
    if (s.v == 8) rowwise_t<uint16_t, 8>(mode, x, dy, v0, v1, v2, out, n, f, rows_per_cta, s, st);
    else rowwise_t<uint16_t, 1>(mode, x, dy, v0, v1, v2, out, n, f, rows_per_cta, s, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Fused whole-graph GraphNorm passes for Hopper (sm_90a), f32 or bf16 x.
//
// Replaces the five Pallas TPU bodies of glass_tpu/ops/pallas_norm.py:
//   K1 _colsum_kernel     (:61)   S1 = sum_n x                  (1, F) f32
//   K2 _varsum_kernel     (:71)   S2 = sum_n (x - am)^2         (1, F) f32
//   K3 _affine_kernel     (:86)   y  = x*g + h                  (N, F) x's type
//   K4 _bwd_reduce_kernel (:92)   R1 = sum_n dy,
//                                 R2 = sum_n dy*(x - am)        2 x (1, F) f32
//   K5 _bwd_dx_kernel     (:106)  dx = dy*a + x*c2 + c1         (N, F) x's type
// with am = mean_scale*mu and g, h, a, c2, c1 per-feature f32 vectors that
// ops/fused_norm.py computes between the launches, as the JAX wrapper does.
//
// Numerics. x and dy are read as stored (f32, or bf16 widened exactly) and
// every sum is taken in f32. K3 and K5 multiply and add in f32 with one
// rounding per operation, in the JAX expression's order (no contraction
// into FMA: __fmul_rn / __fadd_rn), and round the result once to x's type,
// to nearest even as .astype does.
//
// Design. The TPU's sequential grid over 1024-row panels, which carried the
// column sums in its output block, becomes independent CTAs: each CTA owns
// a contiguous range of rows and one tile of columns. Threads map along the
// features with 16-byte vector loads (4 f32 or 8 bf16 values; one value
// when F is not a multiple of that or a pointer is not 16-byte aligned),
// warps map down the rows. The JAX wrapper pads rows to 1024 and columns to
// 128 and masks the padded rows; here every row and column is bound-checked
// instead, so nothing is padded or copied.
//   Reductions (K1, K2, K4): each thread sums its rows, the CTA adds its
//   threads' sums in a fixed order through shared memory and writes one
//   partial (1, F) row per output; finish_kernel then adds the partials of
//   every CTA in a fixed order (one warp per column: a strided sum per lane,
//   then a fixed shuffle tree). No atomics, so a repeated call is
//   bit-identical.
//   Elementwise (K3, K5): each thread keeps the per-feature vectors of its
//   column group in registers for all its rows (its columns never change),
//   then streams its rows.
//
// Bounds on this card at em_user (N = 57,344, F = 64; x f32 is 14.68 MB):
// every pass moves bytes only (at most 3 flops per element, far under the
// f32 rate), so each is bound by bytes at 3.35 TB/s: K1 and K2 one read of
// x (4.38 us f32, 2.19 us bf16), K3 one read and one write (8.76 / 4.38),
// K4 two reads (8.76 / 4.38), K5 two reads and one write (13.15 / 6.57).
// The partials (P x F f32, P <= 512) add under 1 % to K1, K2 and K4.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int DT_F32 = 0;   // ops/fused_norm.py DTYPE_CODES
constexpr int DT_BF16 = 1;
constexpr int RED_SUM = 0;  // K1
constexpr int RED_VAR = 1;  // K2
constexpr int RED_BWD = 2;  // K4
constexpr int EW_AFFINE = 0;  // K3
constexpr int EW_DX = 1;      // K5
constexpr int MAX_V = 8;

__device__ __forceinline__ float widen(float v) { return v; }
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

// V consecutive values of row-major storage at p, widened to f32. V > 1
// only where p is 16-byte aligned and the V values lie in one row.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = widen(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "f32 vectors are float4");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(V == 8, "bf16 vectors are 8 values");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);          // low half first
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
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

// K1, K2, K4: partial[o, blockIdx.x, :] = this CTA's rows' sum of output o.
// Block (TX, TY): TX threads along the column groups of one column tile
// (blockIdx.y), TY down the rows [r0, r1).
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(THREADS)
colreduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ am, float* __restrict__ partial,
                 long long n, int f, long long rows_per_cta) {
  constexpr int NOUT = MODE == RED_BWD ? 2 : 1;
  __shared__ float red[NOUT][THREADS * V];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = (blockIdx.y * blockDim.x + tx) * V;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long r1 = min(n, r0 + rows_per_cta);

  float acc[NOUT][V];
  float amv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    acc[0][v] = 0.f;
    if constexpr (NOUT == 2) acc[1][v] = 0.f;
    amv[v] = (MODE != RED_SUM && c0 + v < f) ? am[c0 + v] : 0.f;
  }
  if (c0 < f) {
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += blockDim.y) {
      float xv[V];
      load<T, V>(x + r * f + c0, xv);
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
        load<T, V>(dy + r * f + c0, dv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[0][v] += dv[v];
          acc[1][v] += dv[v] * (xv[v] - amv[v]);
        }
      }
    }
  }
  const int t = ty * blockDim.x + tx;
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int v = 0; v < V; ++v) red[o][t * V + v] = acc[o][v];
  __syncthreads();
  if (ty != 0 || c0 >= f) return;
  const long long p = gridDim.x;
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (c0 + v >= f) break;
      float s = 0.f;
      for (int k = 0; k < static_cast<int>(blockDim.y); ++k)  // fixed order
        s += red[o][(k * blockDim.x + tx) * V + v];
      partial[(o * p + blockIdx.x) * f + c0 + v] = s;
    }
  }
}

// out[o, c] = sum over k < p of partial[o, k, c], one warp per (o, c): lane l
// sums k = l, l + 32, ... and a fixed shuffle tree adds the lanes.
__global__ void finish_kernel(const float* __restrict__ partial,
                              float* __restrict__ out, int p, int f,
                              int n_out) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= static_cast<long long>(n_out) * f) return;  // whole warps
  const int o = static_cast<int>(warp / f), c = static_cast<int>(warp % f);
  const float* src = partial + static_cast<long long>(o) * p * f + c;
  float s = 0.f;
  for (int k = lane; k < p; k += 32) s += src[static_cast<long long>(k) * f];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[static_cast<long long>(o) * f + c] = s;
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

// The launch shape shared by both families: V values per thread, TX threads
// along the column groups (a power of two up to 32), TY = THREADS / TX down
// the rows, one CTA per (row range, column tile).
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
void reduce_t(int mode, const void* x, const void* dy, const float* am,
              float* partial, long long n, int f, long long rows,
              const Shape& s, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dy);
  if (mode == RED_SUM)
    colreduce_kernel<T, V, RED_SUM><<<s.grid, s.block, 0, st>>>(xp, dp, am, partial, n, f, rows);
  else if (mode == RED_VAR)
    colreduce_kernel<T, V, RED_VAR><<<s.grid, s.block, 0, st>>>(xp, dp, am, partial, n, f, rows);
  else
    colreduce_kernel<T, V, RED_BWD><<<s.grid, s.block, 0, st>>>(xp, dp, am, partial, n, f, rows);
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

// K1 (mode 0: x), K2 (mode 1: x, am) and K4 (mode 2: x, dy, am): writes
// out[o * f + c], o < 1 (K1, K2) or o < 2 (K4: R1 then R2), through
// `partial` (n_out * ceil(n / rows_per_cta) * f floats, allocated by the
// caller). Two launches on `stream`; returns cudaGetLastError() (0 on
// success). The caller checks shapes and types; n >= 1, f >= 1.
extern "C" int glass_norm_reduce(int mode, const void* x, const void* dy,
                                 int dtype, const float* am, float* partial,
                                 float* out, long long n, int f,
                                 long long rows_per_cta, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || f < 1 || rows_per_cta < 1 || mode < RED_SUM || mode > RED_BWD ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape(dtype, aligned16(x) && aligned16(dy), n, f, rows_per_cta);
  if (dtype == DT_F32) {
    if (s.v == 4) reduce_t<float, 4>(mode, x, dy, am, partial, n, f, rows_per_cta, s, st);
    else reduce_t<float, 1>(mode, x, dy, am, partial, n, f, rows_per_cta, s, st);
  } else {
    if (s.v == 8) reduce_t<uint16_t, 8>(mode, x, dy, am, partial, n, f, rows_per_cta, s, st);
    else reduce_t<uint16_t, 1>(mode, x, dy, am, partial, n, f, rows_per_cta, s, st);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = mode == RED_BWD ? 2 : 1;
  const long long threads = static_cast<long long>(n_out) * f * 32;
  finish_kernel<<<static_cast<unsigned>((threads + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      partial, out, static_cast<int>(s.grid.x), f, n_out);
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

// Device code shared by csrc/band_spmm.cu and csrc/bcsr_spmm.cu: the two
// inner loops that consume one 128 x TK stage of an adjacency block against
// TK rows of x, for a CTA of 256 threads that owns a 128-row x 64-column
// output tile.
//
//   f32 blocks (BCSR): fma_stage — the stage widened to f32 in shared
//     memory (stored transposed, padded), each thread an 8 x 4 tile of f32
//     FMAs. Full f32, the counterpart of Precision.HIGHEST. (The band's f32
//     slabs run 3xTF32 on the tensor cores instead, in band_spmm.cu.)
//   bf16 and int8 blocks: mma_stage (or its three steps, mma_load,
//     mma_store and mma_compute) — the stage as bf16 in shared memory
//     (int8 widened exactly), x rounded to bf16 as it is staged, and
//     mma.sync.m16n8k16 bf16 x bf16 -> f32 on the tensor cores, each warp a
//     32 x 32 tile. The products are exact; each mma starts from zero and
//     its sum of 16 products is added to the f32 accumulator with a
//     round-to-nearest add, so the tensor core's own rounding of its
//     accumulation never compounds over a long window.
//
// Storage types: float, uint16_t (bf16 bits), int8_t. Rows of x outside
// [0, n_x_rows) and columns past h read as zero.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace spmm {

constexpr int BLOCK = 128;             // adjacency block edge
constexpr int TN = 64;                 // output columns per CTA
constexpr int TK = 32;                 // depth of one shared-memory stage
constexpr int THREADS = 256;           // 8 warps
constexpr int RM = BLOCK / 16;         // fma: output rows per thread
constexpr int RN = TN / 16;            // fma: output columns per thread
constexpr int A_STRIDE = BLOCK + 1;    // fma: transposed stage row, padded
constexpr int H_STRIDE = TK + 8;       // mma: bf16 stage row, padded

// dtype codes shared with glass_tpu_torch/ops/band_spmm.py::DTYPE_CODES
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;
constexpr int DT_I8 = 2;

static_assert(BLOCK % TK == 0, "a stage must not straddle two blocks");
static_assert(TK % 16 == 0, "mma: whole k16 steps");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }

// bf16 bits of x (rounded to nearest even) and of an int8 value (exact)
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t bf16_bits(uint16_t v) { return v; }
__device__ __forceinline__ uint32_t bf16_bits(int8_t v) {
  return bf16_bits(static_cast<float>(v));
}

struct FmaTile {
  float acc[RM][RN];
};

struct MmaTile {
  float acc[2][4][4];  // [m16 tile][n8 tile][mma C fragment]
};

// Shared memory of one CTA, for either loop.
union __align__(16) StageSmem {
  struct {
    float a[TK * A_STRIDE];  // a[k * A_STRIDE + row]
    float x[TK * TN];        // x[k * TN + col]
  } fma;
  struct {
    uint16_t a[BLOCK * H_STRIDE];  // a[row * H_STRIDE + k], bf16 bits
    uint16_t x[TN * H_STRIDE];     // x[col * H_STRIDE + k], bf16 bits
  } mma;
};

__device__ __forceinline__ void zero(FmaTile& t) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) t.acc[i][j] = 0.f;
}

__device__ __forceinline__ void zero(MmaTile& t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) t.acc[i][j][c] = 0.f;
}

// One f32 stage: a_blk points at row 0, column k0 of the 128-row block
// (row stride a_stride values); x_row0 is the x row of the stage's k = 0.
template <typename X>
__device__ __forceinline__ void fma_stage(const float* __restrict__ a_blk,
                                          long long a_stride,
                                          const X* __restrict__ x,
                                          long long x_row0, int n_x_rows,
                                          int h, int h0, StageSmem& sm,
                                          FmaTile& t) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int p = 0; p < BLOCK * TK / 4 / THREADS; ++p) {
    const int idx = tid + p * THREADS;
    const int r = idx / (TK / 4);  // row of the block
    const int q = idx % (TK / 4);  // float4 along k
    const float4 v = *reinterpret_cast<const float4*>(a_blk + r * a_stride + q * 4);
    sm.fma.a[(q * 4 + 0) * A_STRIDE + r] = v.x;
    sm.fma.a[(q * 4 + 1) * A_STRIDE + r] = v.y;
    sm.fma.a[(q * 4 + 2) * A_STRIDE + r] = v.z;
    sm.fma.a[(q * 4 + 3) * A_STRIDE + r] = v.w;
  }
#pragma unroll
  for (int p = 0; p < TK * TN / THREADS; ++p) {
    const int idx = tid + p * THREADS;
    const int k = idx / TN;
    const int c = idx % TN;
    const long long xr = x_row0 + k;
    const int col = h0 + c;
    sm.fma.x[k * TN + c] = (xr >= 0 && xr < n_x_rows && col < h)
                               ? widen(x[xr * h + col]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < TK; ++k) {
    float a[RM];
    float xv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = sm.fma.a[k * A_STRIDE + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < RN; ++j) xv[j] = sm.fma.x[k * TN + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) t.acc[i][j] = fmaf(a[i], xv[j], t.acc[i][j]);
  }
  __syncthreads();
}

// Calls fn(row, col, value) for each element of the f32 tile, rows relative
// to the CTA's first row, columns to its first column.
template <typename F>
__device__ __forceinline__ void for_each(const FmaTile& t, F fn) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) fn(ty + 16 * i, tx + 16 * j, t.acc[i][j]);
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d = A (16x16 bf16, row-major) @ B (16x8 bf16, col-major), from zero.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// A bf16 or int8 stage in three steps, so that a caller can keep the next
// stage's global reads in flight while this stage multiplies: mma_load reads
// it from global memory into registers as stored (MmaRegs), mma_store writes
// it to shared memory as bf16 (int8 widened exactly, x rounded to nearest
// even), and mma_compute multiplies it on the tensor cores.
template <typename S, typename X>
struct MmaRegs {
  static constexpr int V = 16 / sizeof(S);  // slab values in one 16-byte load
  static constexpr int PER_ROW = TK / V;    // loads per stage row
  static constexpr int NA = BLOCK * PER_ROW / THREADS;
  static constexpr int NX = TK / 2 * TN / THREADS;  // x pairs (k, k+1)
  static_assert((BLOCK * PER_ROW) % THREADS == 0, "slab stage: whole loads");
  uint4 a[NA];
  X x[NX][2];
};

// Arguments as fma_stage's.
template <typename S, typename X>
__device__ __forceinline__ void mma_load(const S* __restrict__ a_blk,
                                         long long a_stride,
                                         const X* __restrict__ x,
                                         long long x_row0, int n_x_rows,
                                         int h, int h0, MmaRegs<S, X>& r) {
  using R = MmaRegs<S, X>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int p = 0; p < R::NA; ++p) {
    const int idx = tid + p * THREADS;
    r.a[p] = *reinterpret_cast<const uint4*>(
        a_blk + (idx / R::PER_ROW) * a_stride + (idx % R::PER_ROW) * R::V);
  }
#pragma unroll
  for (int p = 0; p < R::NX; ++p) {
    const int idx = tid + p * THREADS;
    const int col = h0 + idx % TN;
    const long long xr = x_row0 + 2 * (idx / TN);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      r.x[p][j] = (col < h && xr + j >= 0 && xr + j < n_x_rows)
                      ? x[(xr + j) * h + col] : X(0);
  }
}

template <typename S, typename X>
__device__ __forceinline__ void mma_store(const MmaRegs<S, X>& r,
                                          StageSmem& sm) {
  using R = MmaRegs<S, X>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int p = 0; p < R::NA; ++p) {
    const int idx = tid + p * THREADS;
    uint4* dst = reinterpret_cast<uint4*>(
        sm.mma.a + (idx / R::PER_ROW) * H_STRIDE + (idx % R::PER_ROW) * R::V);
    if constexpr (std::is_same<S, uint16_t>::value) {
      *dst = r.a[p];  // bf16 as stored
    } else {
      union {
        uint4 u;
        int8_t v[16];
      } in;
      in.u = r.a[p];
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j] = bf16_bits(in.v[2 * j]) | (bf16_bits(in.v[2 * j + 1]) << 16);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
  // x pairs (k, k+1) of one column, one 32-bit word each
#pragma unroll
  for (int p = 0; p < R::NX; ++p) {
    const int idx = tid + p * THREADS;
    *reinterpret_cast<uint32_t*>(sm.mma.x + (idx % TN) * H_STRIDE +
                                 2 * (idx / TN)) =
        bf16_bits(r.x[p][0]) | (bf16_bits(r.x[p][1]) << 16);
  }
}

__device__ __forceinline__ void mma_compute(const StageSmem& sm, MmaTile& t) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int m0 = (warp / 2) * 32;       // the warp's 32 rows
  const int n0 = (warp % 2) * 32;       // and 32 columns
#pragma unroll
  for (int kk = 0; kk < TK; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint16_t* base = sm.mma.a + (m0 + mi * 16 + g) * H_STRIDE + kk + 2 * q;
      a[mi][0] = lds32(base);
      a[mi][1] = lds32(base + 8 * H_STRIDE);
      a[mi][2] = lds32(base + 8);
      a[mi][3] = lds32(base + 8 * H_STRIDE + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint16_t* base = sm.mma.x + (n0 + ni * 8 + g) * H_STRIDE + kk + 2 * q;
      const uint32_t b0 = lds32(base);
      const uint32_t b1 = lds32(base + 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float d[4];
        mma_bf16(d, a[mi], b0, b1);
#pragma unroll
        for (int c = 0; c < 4; ++c) t.acc[mi][ni][c] += d[c];
      }
    }
  }
}

// One bf16 or int8 stage on the tensor cores, nothing in flight across it
// (arguments as fma_stage).
template <typename S, typename X>
__device__ __forceinline__ void mma_stage(const S* __restrict__ a_blk,
                                          long long a_stride,
                                          const X* __restrict__ x,
                                          long long x_row0, int n_x_rows,
                                          int h, int h0, StageSmem& sm,
                                          MmaTile& t) {
  MmaRegs<S, X> r;
  mma_load<S, X>(a_blk, a_stride, x, x_row0, n_x_rows, h, h0, r);
  mma_store<S, X>(r, sm);
  __syncthreads();
  mma_compute(sm, t);
  __syncthreads();
}

template <typename F>
__device__ __forceinline__ void for_each(const MmaTile& t, F fn) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int m0 = (warp / 2) * 32;
  const int n0 = (warp % 2) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        fn(m0 + mi * 16 + g + 8 * (c / 2), n0 + ni * 8 + 2 * q + c % 2,
           t.acc[mi][ni][c]);
}

// The tile and stage loop a slab type takes: FMA for f32, mma otherwise.
template <typename S>
using Tile = typename std::conditional<std::is_same<S, float>::value, FmaTile,
                                       MmaTile>::type;

template <typename S, typename X>
__device__ __forceinline__ void stage(const S* a_blk, long long a_stride,
                                      const X* x, long long x_row0,
                                      int n_x_rows, int h, int h0,
                                      StageSmem& sm, Tile<S>& t) {
  if constexpr (std::is_same<S, float>::value) {
    fma_stage<X>(a_blk, a_stride, x, x_row0, n_x_rows, h, h0, sm, t);
  } else {
    mma_stage<S, X>(a_blk, a_stride, x, x_row0, n_x_rows, h, h0, sm, t);
  }
}

}  // namespace spmm

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
// over k < w_blocks*128, and they differ only in how slabs and x reach the
// TPU's VMEM. Rows of x outside [0, n_x) read as zero: the JAX wrappers pad
// x with zeros; this kernel masks the rows instead, so it needs no pass over
// x.
//
// Numerics (those of the MXU up to the order of the sum): bf16 and int8
// slabs multiply bf16 x, so f32 x is rounded to nearest even as it is staged
// (pallas_band.py:870-871); f32 slabs multiply f32 x, and bf16 x is widened
// exactly (:707-708). The per-row scale (int8 only, bf16-rounded values)
// multiplies the f32 sum once. The output is always f32.
//
// Layout (built on the host, identical to the JAX builders'):
//   slabs (n_g, rps*128, w_blocks*128) f32 | bf16 (as uint16 bits) | int8
//   clo   (n_g,) int32 window start of each group in 128-column blocks
//   scale (n_g*rps*128,) f32 or null
//
// Design. One CTA per (128-row block of one group, 64-column tile of H);
// the TPU's sequential grid over groups becomes independent CTAs, and the
// window's columns a loop inside the CTA in 32-deep stages. No atomics, so
// a repeated call is bit-identical.
//   f32 slabs: 3xTF32 on the tensor cores (band_tf32_kernel). Each slab
//     value a and x value v splits into hi = tf32_rna(v), lo = tf32_rna(v -
//     hi) and the kernel takes a_hi*x_hi + a_hi*x_lo + a_lo*x_hi with
//     mma.sync.m16n8k8.tf32 (f32 accumulate), dropping lo*lo (about 2^-22
//     relative): about 21 bits against Precision.HIGHEST's f32. Each k8
//     step starts from zero and its sum is added to the f32 accumulator
//     with a round-to-nearest add. mma.sync and not wgmma: TF32 wgmma takes
//     only K-major operands, and an x tile is N-major (x rows are k). The
//     stages arrive through a ring of RING slots filled by 16-byte cp.async
//     (padded rows, conflict-free fragment reads); the hi/lo split happens
//     on the fragments in registers and is never stored.
//   bf16 and int8 slabs: the mma steps of spmm_common.cuh (bf16 products
//     on mma.sync m16n8k16, f32 sums), one shared-memory buffer; the next
//     stage's global reads wait in registers while a stage multiplies.
//
// Bounds on this card, at the shapes the port runs:
//   em_user band (57,344 nodes, 9M edges, rps 1, w_blocks 3, H = 64):
//   1,342 nonzero 128x128 blocks. f32 slabs and x: 117 MB, 35.0 us at 3.35
//   TB/s; as 3xTF32 8.4 GFLOP, 17 us at 495 TFLOP/s (as f32 FMA 2.8 GFLOP,
//   42 us at 67 TFLOP/s): bytes. int8 slabs with bf16 x: 44 MB, 13 us,
//   against 2.8 us of bf16 tensor-core products: bytes.
// The kernel multiplies the band's zero blocks too; skipping them, and a
// TMA/wgmma pipeline for the bf16 and int8 slabs, are later work.

#include "spmm_common.cuh"

namespace {

using spmm::BLOCK;
using spmm::TN;
using spmm::TK;
using spmm::THREADS;

// ------------------------------------------------------- f32: 3xTF32

constexpr int RING = 3;          // stages in the cp.async ring
constexpr int A_LD = TK + 4;     // slab stage row, padded (36: conflict-free)
constexpr int X_LD = TN + 8;     // x stage row, padded (72: conflict-free)

struct Tf32Stage {
  float a[BLOCK * A_LD];  // a[row * A_LD + k]
  float x[TK * X_LD];     // x[k * X_LD + col]
};
constexpr int TF32_SMEM = RING * sizeof(Tf32Stage);  // 81 KB: 2 CTAs an SM

static_assert(TK % 8 == 0, "tf32: whole k8 steps");
static_assert(sizeof(Tf32Stage) % 16 == 0, "16-byte cp.async destinations");

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// round to TF32 (10 mantissa bits), to nearest, ties away from zero: the
// result of cvt.rna.tf32.f32, in two integer operations (half of the 13
// dropped bits added to the magnitude, then cleared), where cvt runs on the
// conversion units at a quarter of their rate
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += A (16x8 tf32, row-major) @ B (8x8 tf32, col-major)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// XA: x is f32, h % 4 == 0 and x 16-byte aligned, so its stage rows go by
// 16-byte cp.async too; otherwise (bf16 x, or ragged rows) they are loaded,
// widened and stored by the threads. A template parameter, so that the
// main path's registers carry nothing of the other.
template <typename X, bool XA>
__global__ void __launch_bounds__(THREADS, 2)
band_tf32_kernel(const float* __restrict__ slabs, const int* __restrict__ clo,
                 const X* __restrict__ x, float* __restrict__ out, int rps,
                 int w_blocks, int n_x_rows, int n_out_rows, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tf32Stage* ring = reinterpret_cast<Tf32Stage*>(smem);

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

  // this thread's slab pieces: rows tid / 8 + 32 p, 16 bytes at 4 (tid % 8)
  const float* a_src = a_blk + (tid / (TK / 4)) * kw + 4 * (tid % (TK / 4));
  const int a_dst = (tid / (TK / 4)) * A_LD + 4 * (tid % (TK / 4));
  constexpr int A_ROWS = THREADS / (TK / 4);  // rows between its pieces

  auto load = [&](int s) {  // stage s into slot s % RING
    Tf32Stage& st = ring[s % RING];
    const long long k0 = static_cast<long long>(s) * TK;
#pragma unroll
    for (int p = 0; p < BLOCK * TK / 4 / THREADS; ++p)
      cp_async16(&st.a[a_dst + p * A_ROWS * A_LD], a_src + p * A_ROWS * kw + k0,
                 16);
    if constexpr (XA) {
#pragma unroll
      for (int p = 0; p < TK * TN / 4 / THREADS; ++p) {
        const int idx = tid + p * THREADS;
        const int k = idx / (TN / 4);
        const int c = idx % (TN / 4);
        const long long xr = x_row0 + k0 + k;
        const int col = h0 + 4 * c;
        const bool in = xr >= 0 && xr < n_x_rows && col < h;
        const X* src = in ? x + xr * h + col : x;
        cp_async16(&st.x[k * X_LD + 4 * c], src, in ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int p = 0; p < TK * TN / THREADS; ++p) {
        const int idx = tid + p * THREADS;
        const int k = idx / TN;
        const int c = idx % TN;
        const long long xr = x_row0 + k0 + k;
        const int col = h0 + c;
        st.x[k * X_LD + c] = (xr >= 0 && xr < n_x_rows && col < h)
                                 ? spmm::widen(x[xr * h + col]) : 0.f;
      }
    }
  };

  spmm::MmaTile t;
  spmm::zero(t);
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();  // one group per stage, empty ones too
  }
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gq = lane / 4;
  const int q = lane % 4;
  const int m0 = (warp / 2) * 32;       // the warp's 32 rows
  const int n0 = (warp % 2) * 32;       // and 32 columns
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<RING - 2>();  // this thread's copies of stage s landed
    __syncthreads();            // everyone's; and slot (s - 1) % RING is free
    if (s + RING - 1 < n_stages) load(s + RING - 1);
    cp_async_commit();
    const Tf32Stage& st = ring[s % RING];
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* base = st.a + (m0 + mi * 16 + gq) * A_LD + kk + q;
        split(base[0], ahi[mi][0], alo[mi][0]);
        split(base[8 * A_LD], ahi[mi][1], alo[mi][1]);
        split(base[4], ahi[mi][2], alo[mi][2]);
        split(base[8 * A_LD + 4], ahi[mi][3], alo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* base = st.x + (kk + q) * X_LD + n0 + ni * 8 + gq;
        uint32_t bhi0, blo0, bhi1, blo1;
        split(base[0], bhi0, blo0);
        split(base[4 * X_LD], bhi1, blo1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#ifndef GLASS_RING_ONLY  // tools/torch_kernel_variants.py: the ring alone
          mma_tf32(d, alo[mi], bhi0, bhi1);  // the small terms first
          mma_tf32(d, ahi[mi], blo0, blo1);
          mma_tf32(d, ahi[mi], bhi0, bhi1);
#endif
#pragma unroll
          for (int c = 0; c < 4; ++c) t.acc[mi][ni][c] += d[c];
        }
      }
    }
  }

  spmm::for_each(t, [&](int r, int c, float v) {
    const long long row = row0 + r;
    const int col = h0 + c;
    if (row < n_out_rows && col < h) out[row * h + col] = v;
  });
}

// ------------------------------------------------ bf16 and int8 slabs

// The next stage's global reads are issued before this stage's products
// (mma_load into a second set of registers), so they are in flight while the
// tensor cores run.
template <typename S, typename X>
__global__ void __launch_bounds__(THREADS, 2)
band_spmm_kernel(const S* __restrict__ slabs,
                 const int* __restrict__ clo,
                 const float* __restrict__ row_scale,
                 const X* __restrict__ x,
                 float* __restrict__ out,
                 int rps, int w_blocks, int n_x_rows, int n_out_rows, int h) {
  __shared__ spmm::StageSmem sm;

  const int rb = blockIdx.x;            // row block over all groups
  const long long row0 = static_cast<long long>(rb) * BLOCK;
  if (row0 >= n_out_rows) return;       // the last group's padding blocks
  const int g = rb / rps;
  const int h0 = blockIdx.y * TN;
  const long long kw = static_cast<long long>(w_blocks) * BLOCK;  // slab row

  // rows (rb % rps)*128 .. +128 of group g's slab
  const S* a_blk = slabs + (static_cast<long long>(g) * rps + rb % rps) * BLOCK * kw;
  const long long x_row0 = static_cast<long long>(clo[g]) * BLOCK;

  spmm::MmaTile t;
  spmm::zero(t);
  spmm::MmaRegs<S, X> r;
  spmm::mma_load<S, X>(a_blk, kw, x, x_row0, n_x_rows, h, h0, r);
  for (long long k0 = 0; k0 < kw; k0 += TK) {
    spmm::mma_store<S, X>(r, sm);
    __syncthreads();
    if (k0 + TK < kw)
      spmm::mma_load<S, X>(a_blk + k0 + TK, kw, x, x_row0 + k0 + TK, n_x_rows,
                           h, h0, r);
    spmm::mma_compute(sm, t);
    __syncthreads();
  }

  spmm::for_each(t, [&](int r, int c, float v) {
    const long long row = row0 + r;
    const int col = h0 + c;
    if (row < n_out_rows && col < h)
      out[row * h + col] = row_scale ? v * row_scale[row] : v;
  });
}

template <typename S, typename X>
int launch(const void* slabs, const int* clo, const float* row_scale,
           const void* x, float* out, int n_g, int rps, int w_blocks,
           int n_x_rows, int n_out_rows, int h, cudaStream_t stream) {
  const dim3 grid(n_g * rps, (h + TN - 1) / TN);
  if constexpr (std::is_same<S, float>::value) {
    const bool xa = std::is_same<X, float>::value && h % 4 == 0 &&
                    n_x_rows > 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    auto kernel = xa ? band_tf32_kernel<X, true> : band_tf32_kernel<X, false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TF32_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, THREADS, TF32_SMEM, stream>>>(
        static_cast<const float*>(slabs), clo, static_cast<const X*>(x), out,
        rps, w_blocks, n_x_rows, n_out_rows, h);
  } else {
    band_spmm_kernel<S, X><<<grid, THREADS, 0, stream>>>(
        static_cast<const S*>(slabs), clo, row_scale,
        static_cast<const X*>(x), out, rps, w_blocks, n_x_rows, n_out_rows, h);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_x(int x_dtype, const void* slabs, const int* clo,
             const float* row_scale, const void* x, float* out, int n_g,
             int rps, int w_blocks, int n_x_rows, int n_out_rows, int h,
             cudaStream_t stream) {
  if (x_dtype == spmm::DT_F32)
    return launch<S, float>(slabs, clo, row_scale, x, out, n_g, rps, w_blocks,
                            n_x_rows, n_out_rows, h, stream);
  if (x_dtype == spmm::DT_BF16)
    return launch<S, uint16_t>(slabs, clo, row_scale, x, out, n_g, rps,
                               w_blocks, n_x_rows, n_out_rows, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks every shape and allocates `out` (n_out_rows, h); the slabs
// cover n_g * rps >= ceil(n_out_rows / 128) row blocks and are 16-byte
// aligned.
extern "C" int glass_band_spmm(const void* slabs, int slab_dtype,
                               const int* clo, const float* row_scale,
                               const void* x, int x_dtype, float* out,
                               int n_g, int rps, int w_blocks, int n_x_rows,
                               int n_out_rows, int h, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (slab_dtype == spmm::DT_F32)
    return launch_x<float>(x_dtype, slabs, clo, row_scale, x, out, n_g, rps,
                           w_blocks, n_x_rows, n_out_rows, h, s);
  if (slab_dtype == spmm::DT_BF16)
    return launch_x<uint16_t>(x_dtype, slabs, clo, row_scale, x, out, n_g,
                              rps, w_blocks, n_x_rows, n_out_rows, h, s);
  if (slab_dtype == spmm::DT_I8)
    return launch_x<int8_t>(x_dtype, slabs, clo, row_scale, x, out, n_g, rps,
                            w_blocks, n_x_rows, n_out_rows, h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Banded-slab SpMM for Hopper (sm_90a), f32:  out = A @ x.
//
// Replaces six Pallas TPU bodies of glass_tpu/ops/pallas_band.py that
// compute one function:
//   _band_kernel_affine     (:658, affine window law, one x panel per step)
//   _band_kernel            (:465, per-group windows, x windows streamed)
//   _band_kernel_xvmem      (:505, per-group windows, x resident)
//   _band_kernel_xvmem_gps  (:543, gps groups per step, x resident)
//   _band_kernel_gps        (:605, gps groups per step, x streamed)
//   _band_kernel_striped    (:793, the slab copy split into stripes)
// Each computes, for every row-block group g,
//   out[g*rps*128 + r, :H] = sum_k slabs[g, r, k] * x[clo[g]*128 + k, :H]
// over k < w_blocks*128, and they differ only in how slabs and x reach the
// TPU's VMEM. Rows of x outside [0, n_x) read as zero: the JAX wrappers pad
// x with zeros (top-padded by pad_lo blocks for the affine law, whose clo
// may be negative at the top and run past n_cb at the bottom); this kernel
// masks the rows instead, so it needs no pass over x. Both laws come here
// as one int32 clo table (affine_clo for the affine layout).
//
// Layout (built on the host, identical to the JAX builder's):
//   slabs (n_g, rps*128, w_blocks*128) f32, row-major
//   clo   (n_g,) int32 window start of each group, in 128-column blocks
//
// Design. One CTA per (128-row block of one group, 64-column tile of H);
// the TPU's sequential grid over groups becomes independent CTAs, and the
// window's w_blocks*128 columns become a loop inside the CTA in 32-deep
// stages. The slab stage (128 x 32, 16-byte loads, stored transposed with a
// padded stride so neither the stores nor the reads conflict on banks) and
// the x stage (32 x 64, rows masked to [0, n_x), columns to H) go through
// shared memory; each of the 256 threads keeps an 8 x 4 tile of the output
// in f32 registers, updated with fmaf. The tile is written once, rows at or
// past n_node masked. No atomics, so a repeated call is bit-identical; f32
// FMA, not TF32, for parity with Precision.HIGHEST.
//
// Bound at the em_user training shape (57,344 nodes, 9M edges, rps 2,
// w_blocks 4, H = 64): the function needs the 1,342 nonzero 128x128 blocks
// of the band (88 MB f32), x and out (14.7 MB each): about 117 MB, 35 us
// at 3.35 TB/s; and 1,342 * 2 * 128^2 * 64 = 2.8 GFLOP of f32 FMA, 42 us at
// 67 TFLOP/s. Operations bound it. This first kernel also multiplies the
// band's zero blocks (1,792 stored, 1.34x the work) and reads the slabs
// through plain loads on CUDA cores; skipping empty blocks, TMA and wgmma
// are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;             // adjacency block edge
constexpr int TN = 64;                 // output columns per CTA
constexpr int TK = 32;                 // depth of one shared-memory stage
constexpr int THREADS = 256;           // 16 x 16 threads
constexpr int RM = BLOCK / 16;         // output rows per thread (strided by 16)
constexpr int RN = TN / 16;            // output columns per thread (strided)
constexpr int A_STRIDE = BLOCK + 1;    // transposed slab stage row, padded

static_assert(BLOCK % TK == 0, "a stage must not straddle two blocks");
static_assert((BLOCK * TK / 4) % THREADS == 0, "slab stage: whole float4s");
static_assert((TK * TN) % THREADS == 0, "x stage: whole floats");

__global__ void __launch_bounds__(THREADS)
band_spmm_f32_kernel(const float* __restrict__ slabs,
                     const int* __restrict__ clo,
                     const float* __restrict__ x,
                     float* __restrict__ out,
                     int rps, int w_blocks, int n_x_rows, int n_out_rows,
                     int h) {
  __shared__ float a_s[TK * A_STRIDE];  // a_s[k * A_STRIDE + row]
  __shared__ float x_s[TK * TN];        // x_s[k * TN + col]

  const int rb = blockIdx.x;            // row block over all groups
  const long long row0 = static_cast<long long>(rb) * BLOCK;
  if (row0 >= n_out_rows) return;       // the last group's padding blocks
  const int g = rb / rps;
  const int h0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int kw = w_blocks * BLOCK;      // floats in one slab row

  // rows (rb % rps)*128 .. +128 of group g's slab
  const float* a_blk = slabs + (static_cast<long long>(g) * rps + rb % rps) *
                                   BLOCK * static_cast<long long>(kw);
  const long long x_row0 = static_cast<long long>(clo[g]) * BLOCK;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kw; k0 += TK) {
#pragma unroll
    for (int p = 0; p < BLOCK * TK / 4 / THREADS; ++p) {
      const int idx = tid + p * THREADS;
      const int r = idx / (TK / 4);  // row of the block
      const int q = idx % (TK / 4);  // float4 along k
      const float4 v = *reinterpret_cast<const float4*>(
          a_blk + static_cast<long long>(r) * kw + k0 + q * 4);
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
      x_s[k * TN + c] = (xr >= 0 && xr < n_x_rows && col < h)
                            ? x[xr * h + col] : 0.f;
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

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long r = row0 + ty + 16 * i;
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
// caller allocates `out` (n_out_rows, h) and checks every shape; the slabs
// cover n_g * rps >= ceil(n_out_rows / 128) row blocks.
extern "C" int glass_band_spmm_f32(const float* slabs, const int* clo,
                                   const float* x, float* out, int n_g,
                                   int rps, int w_blocks, int n_x_rows,
                                   int n_out_rows, int h, void* stream) {
  const dim3 grid(n_g * rps, (h + TN - 1) / TN);
  band_spmm_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      slabs, clo, x, out, rps, w_blocks, n_x_rows, n_out_rows, h);
  return static_cast<int>(cudaGetLastError());
}

// Row-quantized int8 dense SpMM for Hopper (sm_90a):
//   out[r, :H] = scale[r] * sum_k bf16(q[r, k]) * xb[k, :H]
// with the sum in f32 and an f32 output; rows at or past n_row are not
// written.
//
// Replaces the Pallas TPU kernel glass_tpu/ops/pallas_dense.py:82 (_kernel).
// As the JAX wrapper rounds x to bf16 once outside its kernel
// (pallas_dense.py:147) and keeps it resident, the caller hands this kernel
// x already rounded: xt is x^T in bf16, (H, k_pad), zero past n_x.
// That is the B operand K-major, 1.9 MB at the hpo shape, which stays in L2.
// Its rows (columns of x) stop at H: the tensor map zero-fills a tile's rows
// past H, so the caller pads only k.
//
// Bound on this card at the hpo shape (q 14,592 x 14,592 int8, H = 64):
// 213 MB of q, 65.8 us at 3.35 TB/s, against 27 GFLOP of bf16 products,
// 28 us on the tensor cores: bytes. The design keeps q's bytes in flight and
// does little else per byte:
//   - A TMA ring. One producer thread streams (128 rows x 128 k) int8 q
//     tiles and, per 64 k, (64 columns x 64 k) bf16 xt tiles
//     (cp.async.bulk.tensor.2d, the xt tiles 128-byte swizzled) into
//     STAGES slots, one full and one empty mbarrier per slot. The tensor
//     maps are encoded on the host through cudaGetDriverEntryPoint, so the
//     library does not link libcuda. (The PTX helpers are spmm_common.cuh's,
//     whose TMA + wgmma pipeline serves the BCSR and band kernels' bf16 and
//     int8 layouts.)
//   - Two consumer warpgroups, 64 output rows each. Each widens its rows of
//     the int8 tile exactly to bf16 into a 128-byte-swizzled shared tile
//     (the wgmma canonical K-major layout), then runs wgmma.m64n64k16 bf16 x
//     bf16 -> f32 with both operands from shared memory. The widening takes
//     byte permutes and f32 adds, not the conversion units (a quarter of the
//     rate: with them the widening bound the kernel), into two tiles in
//     turn, so that stage i + 1 is widened while stage i's wgmma runs.
//   - Numerics: every product is exact. wgmma accumulates a stage (128
//     deep) from zero in place; the stage's sum is then added to a separate
//     f32 accumulator with a round-to-nearest add, so the tensor core's own
//     rounding never compounds over the 14,592-deep window.
//   - One CTA per (128-row, 64-column) output tile walks the whole k
//     window and writes its tile once, scaled by row. No atomics: a
//     repeated call is bit-identical.
// What holds it back (PERF.md; tools/torch_kernel_variants.py measures it):
// the ring alone, without widening or wgmma, streams q at about two thirds
// of the HBM rate, and the consumers add a quarter on top. With 193 KB of
// shared memory a CTA, one fits an SM: at hpo 114 row blocks leave 18 of
// 132 SMs idle. A fixed split of k over more CTAs was slower there.

#include "spmm_common.cuh"

namespace {

constexpr int CONSUMERS = 2;       // warpgroups, 64 rows each
constexpr int BM = 64 * CONSUMERS; // output rows per CTA
constexpr int BN = 64;             // output columns per CTA
constexpr int BK = 128;            // depth of one stage
constexpr int ATOM_K = 64;         // bf16 values in one 128-byte swizzled row
constexpr int ATOMS = BK / ATOM_K;
constexpr int STAGES = 4;
constexpr int THREADS = CONSUMERS * 128 + 32;  // + the producer warp
#ifdef GLASS_RING_ONLY  // tools/torch_kernel_variants.py: q's stream alone
constexpr uint32_t STAGE_TX = BM * BK;
#else
constexpr uint32_t STAGE_TX = BM * BK + BN * BK * 2;  // int8 q + bf16 xt
#endif
static_assert(BK % ATOM_K == 0 && 128 % BK == 0, "k_pad is a multiple of 128");

// Swizzled tiles first, each a whole number of 1,024-byte swizzle atoms
// (64 rows of 128 bytes, k atom by k atom).
struct Smem {
  uint16_t xt[STAGES][ATOMS][BN * ATOM_K];  // bf16 bits, TMA 128-byte swizzle
  uint16_t a[CONSUMERS][2][ATOMS][64 * ATOM_K];  // bf16, the swizzle by hand
  int8_t q[STAGES][BM * BK];                // as stored
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // + alignment of the base

using spmm::desc_sw128;
using spmm::fence_operands;
using spmm::make_map;
using spmm::mbar_arrive;
using spmm::mbar_expect_tx;
using spmm::mbar_init;
using spmm::mbar_wait;
using spmm::smem_addr;
using spmm::tma_load_2d;
using spmm::warpgroup_sync;
using spmm::widen8;

__global__ void __launch_bounds__(THREADS, 1)
dense_q_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap x_map,
               const float* __restrict__ scale, float* __restrict__ out,
               int n_row, int h, int n_k) {
  spmm::count_launch(spmm::DT_I8);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // the producer: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS * 128) {
      for (int i = 0; i < n_k; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&sm.empty[s], ((i / STAGES) + 1) & 1);
        // the consumers' reads of the slot are ordered before the refill
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(&sm.full[s], STAGE_TX);
        const int k = i * BK;
        tma_load_2d(sm.q[s], &q_map, k, row0, &sm.full[s]);
#ifndef GLASS_RING_ONLY
#pragma unroll
        for (int j = 0; j < ATOMS; ++j)
          tma_load_2d(sm.xt[s][j], &x_map, k + j * ATOM_K, col0, &sm.full[s]);
#endif
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg*64 .. +64 of the CTA's tile
  const int t = threadIdx.x % 128;
  float acc[32];
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // stage i of the ring, widened into a[wg][i % 2]: its 64 rows of int8 as
  // 16-byte pieces, neighbouring threads on neighbouring pieces of a row;
  // each piece is two 16-byte bf16 chunks
  auto widen_stage = [&](int i) {
    const int s = i % STAGES;
    mbar_wait(&sm.full[s], (i / STAGES) & 1);
#ifndef GLASS_RING_ONLY
#pragma unroll
    for (int p = 0; p < 64 * BK / 16 / 128; ++p) {
      const int u = t + p * 128;
      const int r = u / (BK / 16);
      const int c = 2 * (u % (BK / 16));  // its first bf16 chunk along k
      const uint4 v = *reinterpret_cast<const uint4*>(
          sm.q[s] + (wg * 64 + r) * BK + 8 * c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int atom = (c + j) / 8;
        const int cc = (c + j) % 8;  // the chunk within its 128-byte row
        *reinterpret_cast<uint4*>(sm.a[wg][i % 2][atom] + r * ATOM_K +
                                  ((cc ^ (r & 7)) * 8)) =
            j == 0 ? widen8(v.x, v.y) : widen8(v.z, v.w);
      }
    }
#endif
    // the generic-proxy writes before wgmma's async-proxy reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  widen_stage(0);
  warpgroup_sync(wg);
  for (int i = 0; i < n_k; ++i) {
    const int s = i % STAGES;
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#ifndef GLASS_RING_ONLY
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int atom = kk / (ATOM_K / 16);
      const int off = (kk % (ATOM_K / 16)) * 16;
      spmm::wgmma_m64n64k16<0>(d, desc_sw128(sm.a[wg][i % 2][atom] + off),
                               desc_sw128(sm.xt[s][atom] + off), kk > 0);
    }
#endif
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (i + 1 < n_k) widen_stage(i + 1);  // while the tensor cores run
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(d);
    // the whole warpgroup is done with slot s, a[wg][i % 2] and the writes
    // of a[wg][(i + 1) % 2]
    warpgroup_sync(wg);
    if (t == 0) mbar_arrive(&sm.empty[s]);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += d[j];  // round to nearest
  }

  // the wgmma accumulator layout: warp w of the group holds rows 16w..16w+15
  const int lane = t % 32;
  const int row_base = row0 + wg * 64 + (t / 32) * 16 + lane / 4;
  const int col_base = col0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int row = row_base + 8 * ((j / 2) % 2);
    const int col = col_base + 8 * (j / 4) + (j % 2);
    if (row < n_row && col < h)
      out[static_cast<long long>(row) * h + col] = acc[j] * scale[row];
  }
}

}  // namespace

// The launches of this library's kernels by slab dtype code (f32, bf16,
// int8) since the last reset (spmm_common.cuh count_launch).
extern "C" int glass_launches(unsigned long long* out, int reset) {
  return spmm::read_launches(out, reset);
}

// Launches on `stream` and returns the CUDA error code (0 on success;
// cudaErrorInvalidValue for shapes it does not take or a failed tensor-map
// encoding). q (m_pad, k_pad) int8 and xt (h, k_pad) bf16, both 16-byte
// aligned, m_pad and k_pad multiples of 128; scale (m_pad,) f32; out
// (n_row, h) f32, n_row <= m_pad.
extern "C" int glass_dense_q_spmm(const void* q, const float* scale,
                                  const void* xt, float* out, int m_pad,
                                  int k_pad, int n_row, int h, void* stream) {
  if (m_pad % BM || k_pad % BK || n_row < 1 || n_row > m_pad || h < 1 ||
      reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(xt) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, x_map;
  if (!make_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, k_pad, m_pad, k_pad,
                BK, BM, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xt, k_pad, h,
                static_cast<uint64_t>(k_pad) * 2, ATOM_K, BN,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = spmm::allow_smem(
      reinterpret_cast<const void*>(dense_q_kernel), SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m_pad / BM, (h + BN - 1) / BN);
  dense_q_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      q_map, x_map, scale, out, n_row, h, k_pad / BK);
  return static_cast<int>(cudaGetLastError());
}

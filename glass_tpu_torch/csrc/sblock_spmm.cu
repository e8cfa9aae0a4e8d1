// Sparse-block SpMM for Hopper (sm_90a), f32: out = A @ x, where A's
// stored 128 x 128 blocks list their nonzeros instead of holding them dense.
//
// Replaces no TPU kernel. The JAX package runs every block-sparse product
// on dense 128 x 128 tiles (glass_tpu/ops/pallas_spmm.py), which the MXU
// multiplies at a fixed cost per tile, full or not. On this card a tile
// costs its bytes, and a graph whose blocks are almost empty (the hpo
// stand-in: 6,476,348 nonzeros uniform over 14,587 nodes, every one of its
// 12,996 blocks live at 3.0 % fill) streams 852 MB of BCSR blocks, 97 %
// zeros, for 39 MB of nonzeros. This layout's work and bytes follow the
// nonzeros.
//
// Layout (ops/sblock_spmm.py, built on the host):
//   val        (nnz,) f32     the nonzeros, block by block in layout order,
//                             each block's sorted by local row, then local
//                             column
//   col        (nnz,) uint8   each nonzero's local column
//   row_off    (n_blocks, ROW_LD) int16: row_off[b][r] is where local row
//                             r's nonzeros start within block b's run
//                             (row_off[b][128] its count)
//   stages     (n_stages, 4) int32: the kernel's work, row block by row
//                             block: each block's nonzeros in runs of at
//                             most MCAP, as (first nonzero, block, column
//                             block, offset in the block << 16 | count)
//   stage_ptr  (n_rb + 1,) int32: row block rb's stages
// (the layout's uint8 local rows, block_row_ptr and nz_ptr are the plain
// version's; row_off and the stages carry them here).
//
// Bound at hpo (H = 64): the function needs each nonzero's value and
// column, x read once and out written once: 59.3 MB, 17.7 us at 3.35
// TB/s (benchmark/yardstick.py::spmm_bytes); 0.83 GFLOP of FMA, 12 us at
// 67 TFLOP/s. What the design moves: 32 MB of nonzeros and 3.4 MB of row
// offsets from HBM; one 128 x 64 f32 tile of x (32 KB) a block from L2
// (x, 3.7 MB, stays in the 50 MB L2): 426 MB; and in shared memory a
// 256-byte row of x a nonzero, at least 2 wavefronts of the SM's one a
// clock, plus the nonzero's column and value. The x tiles' copies from L2
// bound it (about 0.13 ms on an H100 at hpo), then shared memory.
//
// Design. One CTA owns a 128-row block and a 64-column tile of out, and
// walks its row block's stages through a ring of RING shared-memory slots:
// a producer warp fills each slot by bulk copies (cp.async.bulk, completing
// on the slot's "full" mbarrier): the stage's descriptor, the 128 x 64 tile
// of x at its column block (one copy when x's rows are 64 columns wide,
// else one a row), its block's row offsets and its nonzeros (a block
// fuller than MCAP takes several stages, the x tile again each time). It
// reads each descriptor one stage early, and refills a slot once every
// consumer warp has arrived on its "empty" mbarrier, so no warp waits on
// the slowest at each stage. The WARPS consumer warps own 8 rows each: a
// quarter of a warp (8 lanes) owns a row and keeps its 64 columns in
// registers (8 a lane); the four quarters of a warp run four rows side by
// side, each adding its row's nonzeros in list order, two at a time: one
// read of the column, one of the value, two 16-byte reads of x a lane,
// eight FMAs each. A row block's sums go to out once, after its last
// stage; an empty row block writes zeros. No atomics: every element of out
// is summed in a fixed order (blocks in layout order, nonzeros in list
// order, one f32 FMA each), so a repeated call is bit-identical. The
// kernel allocates nothing and never syncs with the host, so it runs
// inside a captured CUDA graph. x comes with row stride x_ld (a multiple
// of 4, 16-byte aligned; the wrapper pads an unaligned x); rows past
// n_x_rows read as zero (the producer writes them); columns past h feed
// only columns past h. The values' and columns' storage runs on to whole
// 16-byte pieces (ops/sblock_spmm.py pads it): a stage's copies end on
// one.
//
// On an H100 at hpo: 0.150 ms a call against BCSR's 0.70; the sums and
// copies paced together by a per-stage __syncthreads took 0.26. One CTA a
// row block fills 114 of the card's 132 SMs; a finer split of a row
// block's stages would need a second, fixed-order pass over the partial
// sums.

#include "spmm_common.cuh"

namespace {

using spmm::BLOCK;
constexpr int TC = 64;                 // output columns per CTA
constexpr int RING = 4;                // stages in the ring (3-5: alike)
constexpr int MCAP = 2048;             // nonzeros a stage holds at most
constexpr int ROW_LD = 136;            // int16 row offsets stored a block
constexpr int WARPS = 16;              // consumer warps a CTA (8: slower)

struct Stage {
  float x[BLOCK * TC];                 // x[row * TC + col]
  float val[MCAP + 8];                 // from the 16-byte boundary at or
                                       //   before the stage's first nonzero
  int4 desc;                           // the stage's descriptor
  int16_t row_off[ROW_LD];
  uint8_t col[MCAP + 32];              // from its 16-byte boundary
};
struct Smem {
  Stage ring[RING];
  uint64_t full[RING];
  uint64_t empty[RING];
};
constexpr int SMEM = sizeof(Smem);  // 173 KB: one CTA an SM

static_assert(TC * sizeof(float) == 256, "x rows of 256 bytes");
static_assert(sizeof(Stage) % 16 == 0, "16-byte bulk-copy destinations");
static_assert(ROW_LD >= BLOCK + 1 && ROW_LD % 8 == 0, "whole 16-byte rows");

// descriptor fields: .x first nonzero, .y block, .z column block,
// .w offset of the first nonzero in its block << 16 | count
__device__ __forceinline__ int desc_count(const int4& d) {
  return d.w & 0xFFFF;
}
__device__ __forceinline__ int desc_offset(const int4& d) {
  return d.w >> 16;
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(spmm::smem_addr(dst)), "l"(src), "r"(bytes),
         "r"(spmm::smem_addr(bar))
      : "memory");
}

// The producer warp's copies of stage s (descriptor d) into `st`, completing
// on `bar`: the x tile (one copy when its rows are contiguous, else one a
// row, the lanes in turn; rows past n_x_rows zeroed by the lanes), the row
// offsets, the descriptor and the nonzeros. Lane 0 arms the barrier.
__device__ __forceinline__ void produce(
    Stage& st, uint64_t* bar, const int4* __restrict__ stages, int s,
    const int4& d, const float* __restrict__ val,
    const uint8_t* __restrict__ col, const int16_t* __restrict__ row_off,
    const float* __restrict__ x, int x_ld, int n_x_rows, int h0, int lane) {
  const long long r0 = static_cast<long long>(d.z) * BLOCK;
  const int rows = static_cast<int>(
      max(0LL, min(static_cast<long long>(BLOCK), n_x_rows - r0)));
  const int row_bytes = 4 * min(TC, x_ld - h0);
  const int lo = d.x, hi = d.x + desc_count(d);
  const int a0 = lo & ~3, b0 = lo & ~15;
  const uint32_t val_bytes = ((hi - a0) * 4 + 15) & ~15;
  const uint32_t col_bytes = (hi - b0 + 15) & ~15;
  const uint32_t tx = rows * row_bytes + val_bytes + col_bytes +
                      2 * ROW_LD + 16;
  if (rows < BLOCK) {  // zeros in place of x's missing rows
    float4* z = reinterpret_cast<float4*>(st.x + rows * TC);
    for (int i = lane; i < (BLOCK - rows) * (TC / 4); i += 32)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncwarp();
  if (lane == 0) {
    // the consumers' reads and the lanes' zeros before the copies land
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    spmm::mbar_expect_tx(bar, tx);
    bulk_copy(st.row_off, row_off + static_cast<long long>(d.y) * ROW_LD,
              2 * ROW_LD, bar);
    bulk_copy(&st.desc, stages + s, 16, bar);
    bulk_copy(st.val, val + a0, val_bytes, bar);
    bulk_copy(st.col, col + b0, col_bytes, bar);
  }
  __syncwarp();
  if (row_bytes == 4 * TC && x_ld == TC) {
    if (lane == 0 && rows > 0)
      bulk_copy(st.x, x + r0 * x_ld, rows * row_bytes, bar);
  } else {
    for (int r = lane; r < rows; r += 32)
      bulk_copy(st.x + r * TC, x + (r0 + r) * x_ld + h0, row_bytes, bar);
  }
}

// A quarter of a warp (8 lanes) owns a row: lane t holds its columns
// 4t .. 4t+3 (a0) and 32 + 4t .. 32 + 4t + 3 (a1) of the CTA's 64, and adds
// the row's nonzeros [k, e) of the stage in list order, two at a time. The
// four quarters of a warp run four rows side by side.
__device__ __forceinline__ void fma4(float4& a, float v, const float4& x) {
  a.x = fmaf(v, x.x, a.x);
  a.y = fmaf(v, x.y, a.y);
  a.z = fmaf(v, x.z, a.z);
  a.w = fmaf(v, x.w, a.w);
}

// x row c's columns of this lane: xs + c * TC floats
__device__ __forceinline__ const float4* xrow(const float4* xs, int c) {
  return reinterpret_cast<const float4*>(
      reinterpret_cast<const char*>(xs) + (c << 8));
}

__device__ __forceinline__ void add_row(float4& a0, float4& a1, int k, int e,
                                        const float* v, const uint8_t* cl,
                                        const float4* xs) {
  for (; k + 1 < e; k += 2) {
    const int c0 = cl[k], c1 = cl[k + 1];
    const float v0 = v[k], v1 = v[k + 1];
    const float4* x0 = xrow(xs, c0);
    const float4* x1 = xrow(xs, c1);
    const float4 x00 = x0[0], x01 = x0[8], x10 = x1[0], x11 = x1[8];
    fma4(a0, v0, x00);
    fma4(a1, v0, x01);
    fma4(a0, v1, x10);
    fma4(a1, v1, x11);
  }
  if (k < e) {
    const float4* x0 = xrow(xs, cl[k]);
    const float v0 = v[k];
    fma4(a0, v0, x0[0]);
    fma4(a1, v0, x0[8]);
  }
}

template <int W>
__global__ void __launch_bounds__((W + 1) * 32, 1)
sblock_spmm_kernel(const float* __restrict__ val,
                   const uint8_t* __restrict__ col,
                   const int16_t* __restrict__ row_off,
                   const int4* __restrict__ stages,
                   const int* __restrict__ stage_ptr,
                   const float* __restrict__ x, int x_ld,
                   float* __restrict__ out, int n_x_rows, int n_out_rows,
                   int h) {
  constexpr int ROWS = BLOCK / W;  // output rows a warp owns
  constexpr int RQ = ROWS / 4;     // rows a quarter owns
  spmm::count_launch(spmm::DT_F32);
  extern __shared__ __align__(128) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);

  const int rb = blockIdx.x;
  const int h0 = blockIdx.y * TC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s_lo = stage_ptr[rb], s_hi = stage_ptr[rb + 1];

  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) {
      spmm::mbar_init(&sm.full[i], 1);
      spmm::mbar_init(&sm.empty[i], W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == W) {
    // the producer warp: keeps the ring full along the row block's stages,
    // each stage's descriptor read one stage early
    int4 d = s_lo < s_hi ? stages[s_lo] : make_int4(0, 0, 0, 0);
    for (int s = s_lo; s < s_hi; ++s) {
      const int i = s - s_lo, slot = i % RING;
      const int4 next = s + 1 < s_hi ? stages[s + 1] : d;
      if (i >= RING) spmm::mbar_wait(&sm.empty[slot], ((i / RING) + 1) & 1);
      produce(sm.ring[slot], &sm.full[slot], stages, s, d, val, col, row_off,
              x, x_ld, n_x_rows, h0, lane);
      d = next;
    }
    return;
  }

  const int q = lane / 8, t = lane % 8;
  float4 acc[RQ][2];
#pragma unroll
  for (int j = 0; j < RQ; ++j)
    acc[j][0] = acc[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int s = s_lo; s < s_hi; ++s) {
    const int i = s - s_lo, slot = i % RING;
    spmm::mbar_wait(&sm.full[slot], (i / RING) & 1);
    const Stage& st = sm.ring[slot];
    const int4 d = st.desc;
    const int p0 = desc_offset(d), p1 = p0 + desc_count(d);
    const float* v = st.val + (d.x & 3) - p0;  // v[k]: the block's nonzero k
    const uint8_t* cl = st.col + (d.x & 15) - p0;
    const float4* xs = reinterpret_cast<const float4*>(st.x) + t;
#pragma unroll
    for (int j = 0; j < RQ; ++j) {
      const int r = warp * ROWS + 4 * j + q;
      add_row(acc[j][0], acc[j][1], max(static_cast<int>(st.row_off[r]), p0),
              min(static_cast<int>(st.row_off[r + 1]), p1), v, cl, xs);
    }
    __syncwarp();
    if (lane == 0) spmm::mbar_arrive(&sm.empty[slot]);
  }

#pragma unroll
  for (int j = 0; j < RQ; ++j) {
    const long long row =
        static_cast<long long>(rb) * BLOCK + warp * ROWS + 4 * j + q;
    if (row >= n_out_rows) continue;
    float* o = out + row * h;
    const float sv[8] = {acc[j][0].x, acc[j][0].y, acc[j][0].z, acc[j][0].w,
                         acc[j][1].x, acc[j][1].y, acc[j][1].z, acc[j][1].w};
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = h0 + (u < 4 ? 4 * t + u : 32 + 4 * t + u - 4);
      if (c < h) o[c] = sv[u];
    }
  }
}

template <int W>
int launch(const float* val, const uint8_t* col, const int16_t* row_off,
           const int4* stages, const int* stage_ptr, const float* x, int x_ld,
           float* out, int n_x_rows, int n_out_rows, int h,
           cudaStream_t stream) {
  auto kernel = sblock_spmm_kernel<W>;
  const cudaError_t err =
      spmm::allow_smem(reinterpret_cast<const void*>(kernel), SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_out_rows + BLOCK - 1) / BLOCK, (h + TC - 1) / TC);
  kernel<<<grid, (W + 1) * 32, SMEM, stream>>>(
      val, col, row_off, stages, stage_ptr, x, x_ld, out, n_x_rows,
      n_out_rows, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launches of this library's kernel (slot 0: f32) since the last reset
// (spmm_common.cuh count_launch).
extern "C" int glass_launches(unsigned long long* out, int reset) {
  return spmm::read_launches(out, reset);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (n_out_rows, h), checks every shape, and gives
// 16-byte aligned val, col, row_off, stages and x, x_ld a multiple of 4,
// and val's and col's storage on to whole 16-byte pieces.
extern "C" int glass_sblock_spmm(const float* val, const uint8_t* col,
                                 const int16_t* row_off, const void* stages,
                                 const int* stage_ptr, const float* x,
                                 int x_ld, float* out, int n_x_rows,
                                 int n_out_rows, int h, void* stream) {
  if (n_out_rows <= 0 || h <= 0) return 0;
  return launch<WARPS>(val, col, row_off, static_cast<const int4*>(stages),
                       stage_ptr, x, x_ld, out, n_x_rows, n_out_rows, h,
                       static_cast<cudaStream_t>(stream));
}

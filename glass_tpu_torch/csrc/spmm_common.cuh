// Device code shared by the SpMM kernels of csrc/ (bcsr_spmm.cu,
// band_spmm.cu, dense_q_spmm.cu): the two main loops that multiply 128 x 128
// adjacency blocks with x on the tensor cores, and the PTX they are built
// from.
//
//   f32 blocks: 3xTF32 (tf32_load_a, tf32_load_x, tf32_compute). A CTA of
//     256 threads owns a 128-row x 64-column output tile and walks its
//     blocks in 32-deep stages through a ring of RING shared-memory slots
//     filled by 16-byte cp.async (padded rows: conflict-free fragment
//     reads). Each slab value a and x value v splits into hi = tf32_rna(v),
//     lo = tf32_rna(v - hi), and the stage takes a_hi*x_hi + a_hi*x_lo +
//     a_lo*x_hi with mma.sync.m16n8k8.tf32, dropping lo*lo (about 2^-22
//     relative): about 21 bits against Precision.HIGHEST's f32. Each k8 step
//     starts from zero and its sum is added to the f32 accumulator with a
//     round-to-nearest add. mma.sync and not wgmma: TF32 wgmma takes only
//     K-major operands, and x's rows are k.
//   bf16 and int8 blocks: tc::spmm_kernel, a TMA + wgmma pipeline over a
//     list of (A tile, x k-offset) pairs that a Walk gives each output row
//     block (BCSR: its live blocks; band: its window). One producer thread
//     keeps a ring of STAGES slots full: a 128 x 128 A tile (bf16 landing
//     128-byte swizzled, int8 as stored) and the matching 128 x 64 x tile,
//     bf16, 128-byte swizzled with k as rows (wgmma's MN-major B operand, so
//     x is only cast to bf16 by the wrapper, never transposed). Two consumer
//     warpgroups, 64 rows each, widen int8 exactly into a swizzled bf16 tile
//     (byte permutes and f32 adds; stage i + 1 is widened while stage i's
//     wgmma runs) and run wgmma.m64n64k16 from shared memory. Persistent
//     CTAs walk row blocks rb = blockIdx.x + i * gridDim.x and the ring runs
//     on across row blocks, with an epilogue per row block, so a row of
//     three blocks does not fill and drain a ring of its own.
//   Numerics of both: every product is exact in f32 (bf16 x bf16, int8
//     widened exactly; 3xTF32 up to the dropped lo*lo). A stage (8 deep for
//     TF32, a 128-deep block for wgmma) is summed from zero, then added to a
//     separate f32 accumulator with a round-to-nearest add, so the tensor
//     core's own rounding of its accumulation never compounds over a long
//     row. No atomics: a repeated call is bit-identical.
//
// Storage types: float, uint16_t (bf16 bits), int8_t. Rows of x outside
// [0, n_x_rows) and columns past h read as zero.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace spmm {

constexpr int BLOCK = 128;             // adjacency block edge

// dtype codes shared with glass_tpu_torch/ops/band_spmm.py::DTYPE_CODES
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;
constexpr int DT_I8 = 2;

template <typename S>
__host__ __device__ constexpr int dtype_code() {
  return std::is_same<S, float>::value ? DT_F32
         : std::is_same<S, uint16_t>::value ? DT_BF16 : DT_I8;
}

// The card's own count of this library's kernel launches, one slot per
// slab dtype code: thread 0 of CTA 0 of every launch adds one before
// anything else, so a replayed CUDA graph counts each kernel it runs (the
// host wrappers count a call, once at capture). glass_launches reads them.
namespace {
__device__ unsigned long long g_launches[3];
}

__device__ __forceinline__ void count_launch(int slot) {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y |
       threadIdx.z) == 0)
    atomicAdd(&g_launches[slot], 1ULL);
}

// Copies the counts to out (3 values) and zeroes them when reset is
// non-zero; returns the CUDA error code (0 on success). Synchronous.
inline int read_launches(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[3] = {};
    e = cudaMemcpyToSymbol(g_launches, zero, sizeof(g_launches));
  }
  return static_cast<int>(e);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ f32: 3xTF32

constexpr int TN = 64;                 // output columns per CTA
constexpr int TK = 32;                 // depth of one stage
constexpr int THREADS = 256;           // 8 warps, each a 32 x 32 tile
constexpr int RING = 3;                // stages in the cp.async ring
constexpr int A_LD = TK + 4;           // A stage row, padded (36: conflict-free)
constexpr int X_LD = TN + 8;           // x stage row, padded (72: conflict-free)
constexpr int A_ROWS = THREADS / (TK / 4);  // rows between a thread's A pieces

struct Tf32Stage {
  float a[BLOCK * A_LD];  // a[row * A_LD + k]
  float x[TK * X_LD];     // x[k * X_LD + col]
};
constexpr int TF32_SMEM = RING * sizeof(Tf32Stage);  // 81 KB: 2 CTAs an SM

static_assert(BLOCK % TK == 0, "a stage must not straddle two blocks");
static_assert(TK % 8 == 0, "tf32: whole k8 steps");
static_assert(sizeof(Tf32Stage) % 16 == 0, "16-byte cp.async destinations");

struct MmaTile {
  float acc[2][4][4];  // [m16 tile][n8 tile][mma C fragment]
};

__device__ __forceinline__ void zero(MmaTile& t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) t.acc[i][j][c] = 0.f;
}

// Calls fn(row, col, value) for each element of the tile, rows relative to
// the CTA's first row, columns to its first column.
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

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
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

// The thread's pieces of an A stage (128 rows x TK values): rows tid / 8 +
// 32 p, 16 bytes at 4 (tid % 8). a_src is the thread's first piece in
// global memory (row stride lda values), a_dst its offset in the slot.
__device__ __forceinline__ void tf32_load_a(Tf32Stage& st, const float* a_src,
                                            int a_dst, long long lda) {
#pragma unroll
  for (int p = 0; p < BLOCK * TK / 4 / THREADS; ++p)
    cp_async16(&st.a[a_dst + p * A_ROWS * A_LD], a_src + p * A_ROWS * lda, 16);
}

// An x stage: rows xr0 .. xr0 + TK, columns h0 .. h0 + TN. XA: x is f32, h %
// 4 == 0 and x 16-byte aligned, so the rows go by 16-byte cp.async too;
// otherwise (bf16 x, or ragged rows) they are loaded, widened and stored by
// the threads. A template parameter, so that the main path's registers
// carry nothing of the other.
template <typename X, bool XA>
__device__ __forceinline__ void tf32_load_x(Tf32Stage& st,
                                            const X* __restrict__ x,
                                            long long xr0, int n_x_rows,
                                            int h, int h0) {
  const int tid = threadIdx.x;
  if constexpr (XA) {
#pragma unroll
    for (int p = 0; p < TK * TN / 4 / THREADS; ++p) {
      const int idx = tid + p * THREADS;
      const int k = idx / (TN / 4);
      const int c = idx % (TN / 4);
      const long long xr = xr0 + k;
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
      const long long xr = xr0 + k;
      const int col = h0 + c;
      st.x[k * X_LD + c] = (xr >= 0 && xr < n_x_rows && col < h)
                               ? widen(x[xr * h + col]) : 0.f;
    }
  }
}

// The stage's products: each warp its 32 x 32 tile, per k8 step the three
// TF32 products from zero, then one round-to-nearest add per value.
__device__ __forceinline__ void tf32_compute(const Tf32Stage& st, MmaTile& t) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = lane / 4;
  const int q = lane % 4;
  const int m0 = (warp / 2) * 32;       // the warp's 32 rows
  const int n0 = (warp % 2) * 32;       // and 32 columns
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

// ------------------------------------------------- TMA, mbarrier, wgmma

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// waits for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// tile at coordinates (c0 innermost, c1) of `map` into shared memory,
// completing on `bar`; the box's part outside the tensor reads as zero
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a tile of 128-byte rows, 128-byte swizzled in
// 1,024-byte atoms of 8 rows: start address, leading offset 16 B (unused by
// these layouts), stride 1,024 B between 8-row groups, layout type 1. For a
// K-major operand the rows are M (or N) and the atom spans 64 k; for an
// MN-major B operand the rows are k and the atom spans 64 columns, and the
// stride is the one between groups of 8 k.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (static_cast<uint64_t>(smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (64 x 64 f32 per warpgroup) = [d if scale_d] + A (64 x 16) @ B (16 x 64),
// A K-major; B K-major (TRANS_B 0) or MN-major (TRANS_B 1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// keeps the compiler from moving d across the asynchronous wgmma
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(wg + 1) : "memory");
}

// 8 int8 values (two words) as 8 bf16 values (four words), exactly. A byte
// permute makes byte b the f32 2^23 + (b ^ 0x80), and subtracting 2^23 +
// 128 leaves b; a small integer's f32 has no low mantissa bits, so its
// bf16 bits are its top half, and a second permute packs two of them.
// Integer and f32 adds only: the conversion units (I2F, F2F) run at a
// quarter of the rate and would bound the kernel.
__device__ __forceinline__ uint4 widen8(uint32_t lo, uint32_t hi) {
  constexpr uint32_t MAGIC = 0x4B000000u;  // 2^23
  const uint32_t b[2] = {lo ^ 0x80808080u, hi ^ 0x80808080u};
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t src = b[j / 2];
    const int k = 2 * (j % 2);  // the pair's first byte in its word
    const float f0 = __uint_as_float(__byte_perm(src, MAGIC, 0x7540 + k)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(src, MAGIC, 0x7541 + k)) - 8388736.f;
    w[j] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D row-major map: `inner` values per row of `row_bytes`, `outer` rows;
// a box's part past either end reads as zero
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, uint64_t inner, uint64_t outer,
                     uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Host values that never change between launches, looked up once: the
// launch paths run on every call of a short kernel, whose wrapper's host
// work can outlast its device time.
constexpr int MAX_DEVICES = 64;

// the current device's SM count (0 on an error), read once per device
inline int sm_count() {
  static std::atomic<int> cached[MAX_DEVICES];
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const bool slot = dev >= 0 && dev < MAX_DEVICES;
  if (slot && (sms = cached[dev].load(std::memory_order_relaxed)) > 0)
    return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (slot) cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device: cudaFuncSetAttribute on its first launch there, a table look-up
// on every later one (a kernel's size is a constant). Returns the CUDA
// error code.
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  constexpr int SLOTS = 256;
  static std::mutex mu;
  static const void* done_kernel[SLOTS];
  static int done_dev[SLOTS];
  static int n_done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i)
    if (done_kernel[i] == kernel && done_dev[i] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && n_done < SLOTS) {
    done_kernel[n_done] = kernel;
    done_dev[n_done] = dev;
    ++n_done;
  }
  return err;
}

// --------------------------------- bf16 and int8 blocks: TMA + wgmma

namespace tc {

constexpr int CONSUMERS = 2;        // warpgroups, 64 rows each
constexpr int BM = 64 * CONSUMERS;  // output rows per row block
constexpr int BN = 64;              // output columns per CTA
constexpr int BK = BLOCK;           // one adjacency block a stage
constexpr int ATOM_K = 64;          // bf16 values in one 128-byte swizzled row
constexpr int ATOMS = BK / ATOM_K;
constexpr int STAGES = 4;
constexpr int THREADS = CONSUMERS * 128 + 32;  // + the producer warp
static_assert(BM == BLOCK, "a CTA's row block is one adjacency row block");

// The pairs a Walk gives: the A tile's coordinates (column, row) in its
// tensor map and the first x row it multiplies.
struct Run { int rb, lo, n, aux; };  // row block, first pair, pair count
struct Pair { int a0, a1, xk; };

// Swizzled tiles first, each a whole number of 1,024-byte swizzle atoms.
template <typename S> struct Smem;
template <> struct Smem<int8_t> {
  uint16_t x[STAGES][BK * BN];                   // bf16, k rows, TMA swizzle
  uint16_t a[CONSUMERS][2][ATOMS][64 * ATOM_K];  // widened, swizzled by hand
  int8_t q[STAGES][BM * BK];                     // as stored
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
template <> struct Smem<uint16_t> {
  uint16_t x[STAGES][BK * BN];
  uint16_t a[STAGES][ATOMS][BM * ATOM_K];  // as stored, TMA swizzle
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
template <typename S>
constexpr int smem_bytes() { return sizeof(Smem<S>) + 1024; }  // + alignment

template <typename S>
__host__ __device__ constexpr uint32_t stage_tx() {
#ifdef GLASS_RING_ONLY  // tools/torch_kernel_variants.py: A's stream alone
  return BM * BK * sizeof(S);
#else
  return BM * BK * sizeof(S) + BK * BN * 2;
#endif
}

// out[rb*128 + r, col0 .. col0 + 64] = scale[row] * sum over walk.run(rb)'s
// pairs of A_tile[r, :] @ x[xk .. xk + 128, col0 ..], for the row blocks
// blockIdx.x + i * gridDim.x below ceil(n_out_rows / 128). a_map: int8
// boxes of 128 x 128, no swizzle, or bf16 boxes of 64 x 128, 128-byte
// swizzle; x_map: bf16 boxes of 64 columns x 128 rows, 128-byte swizzle.
template <typename S, typename Walk>
__global__ void __launch_bounds__(THREADS, 1)
spmm_kernel(const __grid_constant__ CUtensorMap a_map,
            const __grid_constant__ CUtensorMap x_map, const Walk walk,
            const float* __restrict__ scale, float* __restrict__ out,
            int n_out_rows, int h) {
  count_launch(dtype_code<S>());
  constexpr bool Q = std::is_same<S, int8_t>::value;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  Smem<S>& sm = *reinterpret_cast<Smem<S>*>(smem_raw + pad);

  const int n_rb = (n_out_rows + BM - 1) / BM;
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
    // the producer: one thread keeps the ring full along the CTA's walk
    if (threadIdx.x == CONSUMERS * 128) {
      int i = 0;
      for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
        const Run run = walk.run(rb);
        for (int t = 0; t < run.n; ++t, ++i) {
          const int s = i % STAGES;
          if (i >= STAGES) mbar_wait(&sm.empty[s], ((i / STAGES) + 1) & 1);
          // the consumers' reads of the slot are ordered before the refill
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_expect_tx(&sm.full[s], stage_tx<S>());
          const Pair p = walk.pair(run, t);
          if constexpr (Q) {
            tma_load_2d(sm.q[s], &a_map, p.a0, p.a1, &sm.full[s]);
          } else {
#pragma unroll
            for (int j = 0; j < ATOMS; ++j)
              tma_load_2d(sm.a[s][j], &a_map, p.a0 + j * ATOM_K, p.a1,
                          &sm.full[s]);
          }
#ifndef GLASS_RING_ONLY
          tma_load_2d(sm.x[s], &x_map, col0, p.xk, &sm.full[s]);
#endif
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg*64 .. +64 of each row block
  const int t = threadIdx.x % 128;
  int total = 0;  // this CTA's stages: the int8 loop widens one ahead
  for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) total += walk.run(rb).n;
  float acc[32];
  float d[32];

  // int8: stage i's 64 rows of the ring's tile widened into a[wg][i % 2],
  // as 16-byte pieces, neighbouring threads on neighbouring pieces of a row;
  // each piece is two 16-byte bf16 chunks
  auto widen_stage = [&](int i) {
    const int s = i % STAGES;
    mbar_wait(&sm.full[s], (i / STAGES) & 1);
    if constexpr (Q) {
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
    }
  };

  if constexpr (Q) {
    if (total > 0) widen_stage(0);
    warpgroup_sync(wg);
  }
  int i = 0;
  for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
    const int n = walk.run(rb).n;
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    for (int k = 0; k < n; ++k, ++i) {
      const int s = i % STAGES;
      if constexpr (!Q) widen_stage(i);  // bf16: only the wait
      fence_operands(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#ifndef GLASS_RING_ONLY
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int atom = kk / (ATOM_K / 16);
        const int off = (kk % (ATOM_K / 16)) * 16;
        const uint16_t* a;
        if constexpr (Q) {
          a = sm.a[wg][i % 2][atom] + off;
        } else {
          a = sm.a[s][atom] + wg * 64 * ATOM_K + off;
        }
        // x's k rows kk*16 .. +16: two 8-row atoms, 2,048 bytes a step
        wgmma_m64n64k16<1>(d, desc_sw128(a), desc_sw128(sm.x[s] + kk * 16 * BN),
                           kk > 0);
      }
#endif
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if constexpr (Q) {
        if (i + 1 < total) widen_stage(i + 1);  // while the tensor cores run
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_operands(d);
      // the whole warpgroup is done with slot s (and for int8 with
      // a[wg][i % 2] and the writes of a[wg][(i + 1) % 2])
      warpgroup_sync(wg);
      if (t == 0) mbar_arrive(&sm.empty[s]);
#ifndef GLASS_RING_ONLY
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] += d[j];  // round to nearest
#endif
    }

    // the wgmma accumulator layout: warp w of the group holds rows
    // 16w .. 16w + 15; value j is (row + 8 ((j / 2) % 2), col 8 (j / 4) + j % 2)
    const int lane = t % 32;
    const long long row_base = static_cast<long long>(rb) * BM + wg * 64 +
                               (t / 32) * 16 + lane / 4;
    const int col_base = col0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const long long row = row_base + 8 * ((j / 2) % 2);
      const int col = col_base + 8 * (j / 4);
      if (row >= n_out_rows || col >= h) continue;
      const float sc = scale ? scale[row] : 1.f;
      float* o = out + row * h + col;
      if (h % 2 == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[j] * sc, acc[j + 1] * sc);
      } else {
        o[0] = acc[j] * sc;
        if (col + 1 < h) o[1] = acc[j + 1] * sc;
      }
    }
  }
}

// Encodes the two maps and launches spmm_kernel<S, Walk> on `stream`: A
// (a_rows, a_cols) of S, row-major; x (n_x, h) bf16 with row stride x_ld
// values (x_ld >= h, x_ld % 8 == 0), both 16-byte aligned. One CTA an SM
// (n_rb or fewer per 64-column tile of h). Returns the CUDA error code.
template <typename S, typename Walk>
int launch(const void* a, long long a_rows, long long a_cols, const void* x,
           int n_x, int x_ld, const Walk& walk, const float* scale, float* out,
           int n_out_rows, int h, cudaStream_t stream) {
  constexpr bool Q = std::is_same<S, int8_t>::value;
  if (n_x < 1 || x_ld < h || x_ld % 8 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || (a_cols * sizeof(S)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map, x_map;
  const bool ok =
      (Q ? make_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, a_cols, a_rows,
                    a_cols, BK, BM, CU_TENSOR_MAP_SWIZZLE_NONE)
         : make_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, a_cols,
                    a_rows, a_cols * 2, ATOM_K, BM,
                    CU_TENSOR_MAP_SWIZZLE_128B)) &&
      make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, h, n_x,
               static_cast<uint64_t>(x_ld) * 2, BN, BK,
               CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = spmm_kernel<S, Walk>;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), smem_bytes<S>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rb = (n_out_rows + BM - 1) / BM;
  const int col_tiles = (h + BN - 1) / BN;
  const int ctas = sm_count() / col_tiles;
  const dim3 grid(ctas < 1 ? 1 : (ctas < n_rb ? ctas : n_rb), col_tiles);
  kernel<<<grid, THREADS, smem_bytes<S>(), stream>>>(a_map, x_map, walk,
                                                     scale, out, n_out_rows, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace spmm

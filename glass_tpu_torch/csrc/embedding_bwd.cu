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
// rows cut into slices of `slice_rows` rows and the slices into chunks of
// SLICES, where slice_rows is a function of the row count alone. Three
// levels, no atomics on the data:
//   1. each slice sums each run of one id inside it row after row, from
//      its first row (a piece);
//   2. each chunk sums each id's pieces in slice order, from the first
//      piece: a partial per (chunk, run of one id inside it), numbered in
//      sorted order, so slice s's first row lies in partial
//      slice_part[s] and id k's partials are [id_part[k], id_part[k + 1]);
//   3. each id cuts its partials, in chunk order, into SEGMENTS segments
//      of ceil(count / SEGMENTS) (the last ones shorter or empty), sums
//      each from 0 and adds the segment sums in order, from 0, into the
//      table's row (f32).
//
// Bound on this card: bytes. g is read once (n_rows x h at its itemsize),
// the order once (perm and sorted_ids, 8 bytes a row), the table's
// gradient written once (n_ids x h f32): em_user, 57,344 x 64 f32, 14.7 MB
// of g, 4.4 us at 3.35 TB/s. The gather of g's rows in sorted order is a
// chain of dependent loads (the row's place, then the row), and at em_user
// there are few rows a thread, so the time goes to latency unless many rows
// are in flight on every SM. The design:
//   - one CTA a chunk (and a tile of at most 32 vector columns): it copies
//     the chunk's perm and sorted_ids into shared memory with one coalesced
//     pass, so no g load waits on an order load and no column thread reads
//     the order from memory again;
//   - SLICES x lanes threads, slice j's lanes walking its rows with UNROLL
//     16-byte loads of g in flight (4 f32 or 8 bf16 columns a lane; one
//     value a lane where a row is not 16-byte aligned), the loads marked
//     streaming (g is read once);
//   - slice_rows grows with the row count (ops/embedding.py::
//     slice_rows_for): short slices at em_user put hundreds of CTAs, and
//     tens of thousands of rows, in flight at once; long ones at the
//     ladder's 2.29M rows keep the partials few (a chunk's partials are one
//     per id in it, not one per slice);
//   - level 2 in shared memory: a piece that continues into the next slice
//     waits in its thread's registers, the next slices' first pieces are
//     left in shared memory, and after one __syncthreads the thread where
//     the run started adds them in slice order and writes the partial;
//   - level 3 in the same launch: after its partials, each CTA takes a
//     ticket of every id in it whose partials span other chunks (a
//     counter per id and column tile in the order's workspace; the facts
//     it needs, part_info, loaded while the rows stream in); the CTA that
//     draws an id's last ticket sums its partials (read from L2), writes
//     the table's row, the zero rows of the ids without rows before it, and
//     puts the counter back to 0, so every launch, and every replay of a
//     captured one, finds them at 0. An id of at most SEGMENTS partials is
//     finished by one slice group's lanes, several such ids side by side;
//     one of more (the ladder's 16 ids, a single id) by all the CTA's
//     groups, a segment each, so no chain of hundreds of dependent adds
//     ends the launch.

#include <cstdint>
#include <cuda_runtime.h>

// Each partial's id and what its finisher needs: {id k, k's first partial,
// k's partial count, the first of the ids without rows just before k}.
struct __align__(16) PartInfo {
  int id, first, count, zero_lo;
};

// The launch's arguments, packed by the wrapper (ops/embedding.py
// _LAUNCH): one ctypes argument. Both structs lie outside the anonymous
// namespace, so that the C entry point that takes them keeps its external
// name.
struct Launch {
  const void* g;             // (n_rows, h), f32 or bf16 bits
  const int* perm;           // (n_rows,)
  const int* sorted_ids;     // (n_rows,)
  const int* slice_part;     // (n_slices + 1,)
  const PartInfo* part_info; // (n_partials,)
  float* partials;           // (n_partials, h) f32
  int* tickets;              // (n_ids * tiles,), 0 at rest
  float* out;                // (n_ids, h) f32
  void* stream;
  long long n_rows;
  int g_bf16, vec, slice_rows, n_ids, last_id, h;
};

namespace {

constexpr int SLICES = 16;      // slices a chunk (ops/embedding.py::SLICES)
constexpr int MAX_SLICE = 64;   // ops/embedding.py::MAX_SLICE_ROWS
constexpr int MAX_LANES = 32;   // vector columns a CTA
constexpr int UNROLL = 8;       // loads in flight a thread
constexpr int SEGMENTS = 16;    // level 3's segments (ops/embedding.py)
static_assert(SEGMENTS == SLICES, "a chunk's slice groups sum the segments");

// The card's own count of this library's launches. Thread 0 of CTA 0 of
// every launch adds one before anything else, so a replayed CUDA graph
// counts each launch it runs (the host wrapper counts a call, once at
// capture). glass_launches reads it.
__device__ unsigned long long g_launches;

__device__ __forceinline__ void count_launch() {
  if ((blockIdx.x | blockIdx.y | threadIdx.x) == 0)
    atomicAdd(&g_launches, 1ULL);
}

// A vector of VEC columns of g: its load (streaming, 16 bytes where VEC >
// 1) and its widening to f32 (bf16 bits to f32 is exact).
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void widen(const Raw& r, float* o) {
    o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
  }
};

template <>
struct Vec<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void widen(const Raw& r, float* o) {
    o[0] = r;
  }
};

template <>
struct Vec<uint16_t, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void widen(const Raw& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec<uint16_t, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ void widen(const Raw& r, float* o) {
    o[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
};

// VEC f32 values to and from memory: one 16-byte access where VEC is 4 or
// 8 (the caller holds the address 16-byte aligned), else one value.
template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1],
                                                      v[i + 2], v[i + 3]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_l2(const float* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 r = __ldcg(reinterpret_cast<const float4*>(p + i));
      v[i] = r.x; v[i + 1] = r.y; v[i + 2] = r.z; v[i + 3] = r.w;
    }
  }
}

struct Args {
  Launch l;
  int n_slices, lanes, n_vec, tiles;
};

// Partials [p, end) at the vector column at col, added from 0 in order.
template <int VEC>
__device__ __forceinline__ void segment_sum(const Args& a, long long p,
                                            long long end, long long col,
                                            float* acc) {
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
  for (; p < end; p += UNROLL) {
    float w[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p + u < end)
        load_l2<VEC>(a.l.partials + (p + u) * a.l.h + col, w[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p + u < end) {
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[c] = __fadd_rn(acc[c], w[u][c]);
      }
  }
}

// The zero rows of the ids without rows before id k (from zero_lo), and
// after it where k is the last id with rows, at vector column v.
template <int VEC>
__device__ __forceinline__ void zero_gaps(const Args& a, const PartInfo& f,
                                          long long col) {
  float z[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) z[c] = 0.0f;
  for (int k = f.zero_lo; k < f.id; ++k)
    store<VEC>(a.l.out + static_cast<long long>(k) * a.l.h + col, z);
  if (f.id == a.l.last_id)
    for (int k = f.id + 1; k < a.l.n_ids; ++k)
      store<VEC>(a.l.out + static_cast<long long>(k) * a.l.h + col, z);
}

template <typename T, int VEC>
__global__ void chunk_kernel(Args a) {
  using V = Vec<T, VEC>;
  using Raw = typename V::Raw;
  count_launch();
  extern __shared__ int smem[];
  const int S = a.l.slice_rows, C = SLICES * S;
  int* s_perm = smem;
  int* s_ids = smem + C;
  float* s_first = reinterpret_cast<float*>(smem + 2 * C);
  PartInfo* s_fin = reinterpret_cast<PartInfo*>(
      s_first + SLICES * a.lanes * VEC);
  int* s_parts = reinterpret_cast<int*>(s_fin + SLICES);

  const int b = blockIdx.x;
  const long long r0 = static_cast<long long>(b) * C;
  const int rows = static_cast<int>(min(static_cast<long long>(C),
                                        a.l.n_rows - r0));
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    s_perm[i] = a.l.perm[r0 + i];
    s_ids[i] = a.l.sorted_ids[r0 + i];
  }
  if (threadIdx.x < 2)  // the chunk's partials: [s_parts[0], s_parts[1])
    s_parts[threadIdx.x] =
        a.l.slice_part[min((b + static_cast<int>(threadIdx.x)) * SLICES,
                           a.n_slices)];
  __syncthreads();

  const int j = threadIdx.x / a.lanes;
  const int lane = threadIdx.x - j * a.lanes;
  const int v = blockIdx.y * a.lanes + lane;  // vector column
  const bool live = v < a.n_vec;
  const long long col = static_cast<long long>(v) * VEC;
  const int lo = j * S, hi = min(lo + S, rows);
  const T* g = static_cast<const T*>(a.l.g);
  float* first = s_first + (j * a.lanes + lane) * VEC;
  const int p0 = s_parts[0], p1 = s_parts[1];
  // the first round's ticket facts, loaded while the rows stream in
  PartInfo info{};
  if (lane == 0 && p0 + j < p1) info = a.l.part_info[p0 + j];

  // Level 1 over the slice's rows; each closed piece either is a partial
  // (written), or continues from the slice before (left in shared memory),
  // or continues into the next slice (kept: `pending`).
  bool pending = false;
  long long pend_slot = 0;
  int cur = -1;
  float acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
  if (live && lo < hi) {
    const long long slot0 = a.l.slice_part[b * SLICES + j];
    const bool cont_prev = j > 0 && s_ids[lo] == s_ids[lo - 1];
    const bool cont_next = hi < rows && s_ids[hi] == s_ids[hi - 1];
    int run = -1;
    for (int base = lo; base < hi; base += UNROLL) {
      Raw buf[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (base + u < hi)
          buf[u] = __ldcs(reinterpret_cast<const Raw*>(
              g + static_cast<long long>(s_perm[base + u]) * a.l.h + col));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (base + u >= hi) continue;
        float w[VEC];
        V::widen(buf[u], w);
        const int id = s_ids[base + u];
        if (id != cur) {
          if (run == 0 && cont_prev)
            store<VEC>(first, acc);
          else if (run >= 0)
            store<VEC>(a.l.partials + (slot0 + run) * a.l.h + col, acc);
          ++run;
          cur = id;
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[c] = w[c];
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[c] = __fadd_rn(acc[c], w[c]);
        }
      }
    }
    if (run == 0 && cont_prev) {
      store<VEC>(first, acc);
    } else if (cont_next) {
      pending = true;
      pend_slot = slot0 + run;
    } else {
      store<VEC>(a.l.partials + (slot0 + run) * a.l.h + col, acc);
    }
  }
  __syncthreads();

  // Level 2: the run that continues past this slice adds the next slices'
  // first pieces, in slice order, while they hold its id.
  if (pending) {
    for (int jj = j + 1; jj < SLICES; ++jj) {
      const int l = jj * S;
      if (l >= rows || s_ids[l] != cur) break;
      float w[VEC];
      const float* f = s_first + (jj * a.lanes + lane) * VEC;
#pragma unroll
      for (int c = 0; c < VEC; ++c) w[c] = f[c];
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[c] = __fadd_rn(acc[c], w[c]);
    }
    store<VEC>(a.l.partials + pend_slot * a.l.h + col, acc);
  }

  // Level 3: the chunk's partials SLICES at a time, slice j's lane 0
  // drawing the ticket of partial p0 + j's id (none where the id lies in
  // this chunk alone). An id whose last ticket this CTA draws is finished
  // here: by its drawing group where it has at most SEGMENTS partials, by
  // all groups (a segment each, the sums left in s_first) where more.
  __threadfence();  // this CTA's partials, before its tickets
  __syncthreads();
  for (int base = p0; base < p1; base += SLICES) {
    if (lane == 0) {
      const int q = base + j;
      if (base != p0 && q < p1) info = a.l.part_info[q];
      bool fin = q < p1;
      if (fin && info.count > 1) {
        int* t = a.l.tickets + static_cast<long long>(info.id) * a.tiles +
                 blockIdx.y;
        fin = atomicAdd(t, 1) == info.count - 1;
        if (fin) *t = 0;  // every other chunk of the id has drawn its ticket
      }
      if (!fin) info.id = -1;
      s_fin[j] = info;
    }
    __syncthreads();
    __threadfence();  // the other chunks' partials, after the tickets
    const PartInfo f = s_fin[j];
    if (f.id >= 0 && f.count <= SEGMENTS && live) {
      // each segment holds one partial or none: the partials added from 0
      // in order are the same bits (0 + x is x but for the sign of a zero,
      // and a sum from +0 never holds -0)
      float r[VEC];
      segment_sum<VEC>(a, f.first, f.first + f.count, col, r);
      store<VEC>(a.l.out + static_cast<long long>(f.id) * a.l.h + col, r);
      zero_gaps<VEC>(a, f, col);
    }
    for (int i = 0; i < SLICES; ++i) {
      const PartInfo fi = s_fin[i];
      if (fi.id < 0 || fi.count <= SEGMENTS) continue;  // the same in all
      const int len = (fi.count + SEGMENTS - 1) / SEGMENTS;
      const int slo = min(j * len, fi.count), shi = min(slo + len, fi.count);
      if (live) {
        float r[VEC];
        segment_sum<VEC>(a, fi.first + slo, fi.first + shi, col, r);
        store<VEC>(first, r);
      }
      __syncthreads();
      if (j == 0 && live) {
        float r[VEC], w[VEC];
#pragma unroll
        for (int c = 0; c < VEC; ++c) r[c] = 0.0f;
        for (int sg = 0; sg < SEGMENTS; ++sg) {
          const float* src = s_first + (sg * a.lanes + lane) * VEC;
#pragma unroll
          for (int c = 0; c < VEC; ++c) w[c] = src[c];
#pragma unroll
          for (int c = 0; c < VEC; ++c) r[c] = __fadd_rn(r[c], w[c]);
        }
        store<VEC>(a.l.out + static_cast<long long>(fi.id) * a.l.h + col, r);
        zero_gaps<VEC>(a, fi, col);
      }
      __syncthreads();
    }
    __syncthreads();  // s_fin is written again
  }
}

template <typename T, int VEC>
int launch(const Args& a, cudaStream_t st) {
  const int c = SLICES * a.l.slice_rows;
  const long long n_chunks = (a.l.n_rows + c - 1) / c;
  const size_t smem = sizeof(int) * (2 * c + 2) +
                      sizeof(PartInfo) * SLICES +
                      sizeof(float) * SLICES * a.lanes * VEC;
  chunk_kernel<T, VEC><<<dim3(static_cast<unsigned>(n_chunks), a.tiles),
                         SLICES * a.lanes, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the backward described by *l on l->stream as one launch and returns
// the CUDA error code (0 on success). g is (n_rows, h) contiguous, f32
// (g_bf16 == 0) or bf16 bits; vec the columns a lane loads at once (4 for
// f32 or 8 for bf16, which needs h a multiple of vec and g 16-byte
// aligned, or 1); perm and sorted_ids (n_rows,) int32; slice_part
// (n_slices + 1,) int32; part_info (n_partials,); partials (n_partials, h)
// f32; tickets (n_ids * tiles,) int32, all 0 (left so); out (n_ids, h)
// f32, where tiles = ceil(h / vec / 32); last_id the largest id with rows.
// The caller checks every shape; n_rows >= 1.
extern "C" int glass_embedding_bwd(const Launch* l) {
  const int want = l->g_bf16 ? 8 : 4;
  const long long c = static_cast<long long>(SLICES) * l->slice_rows;
  if (l->n_rows < 1 || l->slice_rows < 1 || l->slice_rows > MAX_SLICE ||
      l->n_ids < 1 || l->h < 1 || (l->n_rows + c - 1) / c > 0x7fffffffLL ||
      (l->vec != 1 && (l->vec != want || l->h % l->vec != 0 ||
                       reinterpret_cast<uintptr_t>(l->g) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{*l, static_cast<int>((l->n_rows + l->slice_rows - 1) /
                              l->slice_rows),
         0, l->h / l->vec, 0};
  a.lanes = a.n_vec < MAX_LANES ? a.n_vec : MAX_LANES;
  a.tiles = (a.n_vec + a.lanes - 1) / a.lanes;
  cudaStream_t st = static_cast<cudaStream_t>(l->stream);
  if (l->g_bf16)
    return l->vec == 1 ? launch<uint16_t, 1>(a, st)
                       : launch<uint16_t, 8>(a, st);
  return l->vec == 1 ? launch<float, 1>(a, st) : launch<float, 4>(a, st);
}

// The launches since the last reset (count_launch), zeroed when reset is
// non-zero; the CUDA error code. Synchronous.
extern "C" int glass_launches(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    e = cudaMemcpyToSymbol(g_launches, &zero, sizeof(g_launches));
  }
  return static_cast<int>(e);
}

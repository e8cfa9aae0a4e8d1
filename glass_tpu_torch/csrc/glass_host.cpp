// glass_host: native host-side runtime of glass_tpu_torch, the port's own
// copy of the JAX package's host library, made lean for graphs of hundreds
// of millions of edges.
//
// The card's compute path is the package's CUDA kernels; this library covers
// the host-side data plane around it, the pieces a deployment runs per
// dataset or per partition rebuild, where Python-loop costs bite:
//   - CSR build: sort + degree + {mean,sum,gcn} normalization
//     (semantics of ops/graph.py::build_graph, reference impl/models.py:83-111)
//   - reverse Cuthill-McKee ordering (locality for block-sparse / partitioned
//     layouts)
//   - link-prediction negative sampling (reference datasets.py:73-91)
//   - induced-subgraph extraction for GNN-seg (reference GNNSeg.py:213-249)
//   - the block-sparse layouts' statistics and fills: the stable order of
//     the edges by column, each row block's nonzero column blocks, and the
//     band and BCSR fills
//
// Every entry point returns what the JAX package's library returns, byte for
// byte, with less memory: no edge-sized array of 16-byte keys and no
// accumulator the size of a whole layout. Exposed as a plain C ABI consumed
// through ctypes (glass_tpu_torch/native.py); every entry point has a numpy
// fallback so the framework works unbuilt.

#include <algorithm>
#ifdef _OPENMP
#include <omp.h>
#include <parallel/algorithm>
#endif
#include <cstdint>
#include <cstring>
#include <cmath>
#include <numeric>
#include <queue>
#include <random>
#include <unordered_set>
#include <vector>

namespace {

// The threads a parallel pass over `e` items splits into: one without
// OpenMP, and never more than 16 (each keeps a histogram of the keys, 8
// bytes a key).
int pass_threads(int64_t e) {
#ifdef _OPENMP
  const int t = omp_get_max_threads();
  return static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(
      {static_cast<int64_t>(t), int64_t{16}, e / 65536 + 1})));
#else
  (void)e;
  return 1;
#endif
}

// The stable order of `e` items by their key (0 <= key < n): out[k] is the
// item at rank k, items of one key in input order (a counting sort; each
// thread counts and places one contiguous range of the items). Returns 1 if
// a key lies outside [0, n).
template <typename K, typename P>
int stable_key_order(const K* key, int64_t e, int64_t n, P* out) {
  const int T = pass_threads(e);
  std::vector<int64_t> count(static_cast<size_t>(T) * (n + 1), 0);
  int bad = 0;
#pragma omp parallel num_threads(T) reduction(|| : bad)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    int64_t* c = count.data() + static_cast<size_t>(t) * (n + 1);
    for (int64_t i = e * t / T; i < e * (t + 1) / T; ++i) {
      const int64_t k = key[i];
      if (k < 0 || k >= n) { bad = 1; break; }
      ++c[k];
    }
  }
  if (bad) return 1;
  // each thread's first slot of each key: keys in order, threads in order
  int64_t at = 0;
  for (int64_t k = 0; k < n; ++k) {
    for (int t = 0; t < T; ++t) {
      int64_t& c = count[static_cast<size_t>(t) * (n + 1) + k];
      const int64_t m = c;
      c = at;
      at += m;
    }
  }
#pragma omp parallel num_threads(T)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    int64_t* c = count.data() + static_cast<size_t>(t) * (n + 1);
    for (int64_t i = e * t / T; i < e * (t + 1) / T; ++i)
      out[c[key[i]]++] = static_cast<P>(i);
  }
  return 0;
}

// glass_build_csr's order and outputs over positions of type P (int32_t
// while the edges fit it): the edges counted into their rows, each row's
// then sorted by (col, input position).
template <typename P>
int build_csr(const int64_t* row, const int64_t* col, const float* w,
              int64_t e, int64_t n, int aggr, int32_t* out_row,
              int32_t* out_col, float* out_w, double* out_deg) {
  std::vector<P> perm(e);
  if (stable_key_order(row, e, n, perm.data())) return 1;
  {
    std::vector<int64_t> ptr(n + 1, 0);
    for (int64_t i = 0; i < e; ++i) ptr[row[i] + 1]++;
    for (int64_t i = 0; i < n; ++i) ptr[i + 1] += ptr[i];
#pragma omp parallel
    {
      // each row's (column, position) pairs sorted in a buffer of the
      // thread's own, so the sort reads no column out of place; ties on the
      // column in input order
      std::vector<std::pair<int64_t, P>> buf;
#pragma omp for schedule(dynamic, 1024)
      for (int64_t r = 0; r < n; ++r) {
        P* p = perm.data() + ptr[r];
        const int64_t m = ptr[r + 1] - ptr[r];
        buf.resize(m);
        for (int64_t k = 0; k < m; ++k) buf[k] = {col[p[k]], p[k]};
        std::sort(buf.begin(), buf.end());
        for (int64_t k = 0; k < m; ++k) p[k] = buf[k].second;
      }
    }
  }
  std::vector<double> deg(n, 0.0);
  for (int64_t i = 0; i < e; ++i) {
    deg[row[i]] += w ? static_cast<double>(w[i]) : 1.0;
  }
  for (int64_t i = 0; i < n; ++i) {
    if (deg[i] < 0.5) deg[i] += 1.0;  // isolated-node guard
    out_deg[i] = deg[i];
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < e; ++i) {
    const int64_t j = perm[i];
    const double wj = w ? static_cast<double>(w[j]) : 1.0;
    out_row[i] = static_cast<int32_t>(row[j]);
    out_col[i] = static_cast<int32_t>(col[j]);
    double v;
    switch (aggr) {
      case 0: v = wj; break;                                   // sum
      case 1: v = wj / deg[row[j]]; break;                     // mean
      case 2: v = wj / std::sqrt(deg[row[j]] * deg[col[j]]); break;  // gcn
      default: v = 0.0; break;  // unreachable: aggr validated in python
    }
    out_w[i] = static_cast<float>(v);
  }
  return 0;
}

// The edge range [lo, hi) of each 128-row block of row-sorted `row`.
inline void row_block_range(const int32_t* row, int64_t e, int64_t rb,
                            int64_t* lo, int64_t* hi) {
  *lo = std::lower_bound(row, row + e, static_cast<int64_t>(rb * 128)) - row;
  *hi = std::lower_bound(row + *lo, row + e,
                         static_cast<int64_t>((rb + 1) * 128)) - row;
}

bool rows_sorted(const int32_t* row, int64_t e) {
  int bad = 0;
#pragma omp parallel for schedule(static) reduction(|| : bad)
  for (int64_t i = 1; i < e; ++i) {
    if (row[i] < row[i - 1]) bad = 1;
  }
  return !bad;
}

}  // namespace

extern "C" {

// Sorts edges by (row, col), computes weighted row degrees, applies the
// requested normalization. aggr: 0 = sum, 1 = mean, 2 = gcn.
// In:  row/col/w of length e (w may be null => ones), n nodes.
// Out: out_row/out_col (int32), out_w (float) of length e, out_deg (double, n).
// Returns 0 on success, 1 if a row lies outside [0, n).
// The order is the (row, col) order with ties in input order, as a sort of
// (row*n + col, index) pairs gives it, reached without such pairs: a stable
// counting sort by row into 4-byte positions (8-byte past 2^31 edges), then
// each row's positions sorted by (column, position). The degrees are summed in
// input order and the weights computed in f64, as before.
int glass_build_csr(const int64_t* row, const int64_t* col, const float* w,
                    int64_t e, int64_t n, int aggr,
                    int32_t* out_row, int32_t* out_col, float* out_w,
                    double* out_deg) {
  if (e < (int64_t{1} << 31))
    return build_csr<int32_t>(row, col, w, e, n, aggr, out_row, out_col,
                              out_w, out_deg);
  return build_csr<int64_t>(row, col, w, e, n, aggr, out_row, out_col, out_w,
                            out_deg);
}

// The stable order of the edges by column: out_perm[k] is the edge at rank
// k, the edges of one column in input order (numpy's argsort(col,
// kind="stable")). e < 2^31. Returns 0, or 1 if a column lies outside
// [0, n).
int glass_col_order(const int32_t* col, int64_t e, int64_t n,
                    int32_t* out_perm) {
  return stable_key_order(col, e, n, out_perm);
}

// The nonzero 128x128 blocks of a row-sorted edge list (w[i] != 0 counts):
// for each of the n_rb row blocks, its distinct column blocks ascending and
// the edges in each. With out_cb null, writes each row block's count of
// blocks to out_n (n_rb); else writes the blocks of row block rb at
// [out_n[rb], out_n[rb + 1]) of out_cb (column block) and out_cnt (edges),
// out_n then holding the n_rb + 1 offsets. Columns must lie in [0, n_cb*128).
// Returns 0, 1 on a column outside, 2 if the rows are not sorted.
int glass_block_counts(const int32_t* row, const int32_t* col, const float* w,
                       int64_t e, int64_t n_rb, int64_t n_cb, int64_t* out_n,
                       int32_t* out_cb, int64_t* out_cnt) {
  if (!rows_sorted(row, e)) return 2;
  int bad = 0;
#pragma omp parallel reduction(|| : bad)
  {
    std::vector<int64_t> cnt(n_cb, 0);
    std::vector<int32_t> seen;
#pragma omp for schedule(dynamic, 16)
    for (int64_t rb = 0; rb < n_rb; ++rb) {
      int64_t lo, hi;
      row_block_range(row, e, rb, &lo, &hi);
      seen.clear();
      for (int64_t i = lo; i < hi; ++i) {
        if (w[i] == 0.0f) continue;
        const int64_t cb = col[i] >> 7;
        if (col[i] < 0 || cb >= n_cb) { bad = 1; break; }
        if (cnt[cb]++ == 0) seen.push_back(static_cast<int32_t>(cb));
      }
      std::sort(seen.begin(), seen.end());
      if (out_cb == nullptr) {
        out_n[rb] = static_cast<int64_t>(seen.size());
      } else {
        int64_t at = out_n[rb];
        for (int32_t cb : seen) {
          out_cb[at] = cb;
          out_cnt[at++] = cnt[cb];
        }
      }
      for (int32_t cb : seen) cnt[cb] = 0;
    }
  }
  return bad ? 1 : 0;
}

// BCSR fill from a row-sorted edge list in input order (no permutation of
// the edges by block): row block rb's nonzero blocks are glass_block_counts'
// blk_cb[blk_ptr[rb] .. blk_ptr[rb + 1]), stored from slot slot_ptr[rb] on,
// the rest of its slots up to slot_ptr[rb + 1] zero (the CHUNK padding);
// out is (n_store, 128, chunk*128) f32, slot s at chunk s / chunk, columns
// (s % chunk)*128 .. +128, and every stored chunk past slot_ptr[n_rb] zero.
// Each value is the f64 sum of its edges in input order rounded to f32: the
// sum glass_bcsr_fill forms over the edges stably sorted by block. The
// accumulator is one row block's nonzero blocks a thread. Returns 0, or 1
// if an edge's block is not in the table.
int glass_bcsr_fill_rows(const int32_t* row, const int32_t* col,
                         const float* w, int64_t e, int64_t n_rb,
                         int64_t n_cb, const int64_t* blk_ptr,
                         const int32_t* blk_cb, const int32_t* slot_ptr,
                         int64_t chunk, int64_t n_store, float* out) {
  const int64_t store_cols = chunk * 128;
  int bad = 0;
#pragma omp parallel reduction(|| : bad)
  {
    std::vector<int32_t> pos(n_cb, -1);
    std::vector<double> acc;
#pragma omp for schedule(dynamic, 16)
    for (int64_t rb = 0; rb < n_rb; ++rb) {
      const int64_t b0 = blk_ptr[rb], nb = blk_ptr[rb + 1] - b0;
      for (int64_t k = 0; k < nb; ++k) pos[blk_cb[b0 + k]] =
          static_cast<int32_t>(k);
      acc.assign(static_cast<size_t>(nb) * 128 * 128, 0.0);
      int64_t lo, hi;
      row_block_range(row, e, rb, &lo, &hi);
      for (int64_t i = lo; i < hi; ++i) {
        if (w[i] == 0.0f) continue;
        const int64_t c = col[i];
        const int32_t k = (c >= 0 && (c >> 7) < n_cb) ? pos[c >> 7] : -1;
        if (k < 0) { bad = 1; break; }
        acc[(static_cast<int64_t>(k) * 128 + (row[i] & 127)) * 128 + (c & 127)]
            += static_cast<double>(w[i]);
      }
      for (int64_t s = slot_ptr[rb]; s < slot_ptr[rb + 1]; ++s) {
        const int64_t k = s - slot_ptr[rb];
        float* dst = out + (s / chunk) * 128 * store_cols + (s % chunk) * 128;
        for (int64_t r = 0; r < 128; ++r) {
          float* d = dst + r * store_cols;
          if (k < nb) {
            const double* a = acc.data() + (k * 128 + r) * 128;
            for (int64_t c = 0; c < 128; ++c) d[c] = static_cast<float>(a[c]);
          } else {
            std::fill(d, d + 128, 0.0f);
          }
        }
      }
      for (int64_t k = 0; k < nb; ++k) pos[blk_cb[b0 + k]] = -1;
    }
  }
  if (bad) return 1;
  const int64_t done = n_rb ? (slot_ptr[n_rb] / chunk) : 0;
  if (n_store > done)
    std::fill(out + done * 128 * store_cols, out + n_store * 128 * store_cols,
              0.0f);
  return 0;
}

// Reverse Cuthill-McKee ordering. Edges must describe an undirected graph
// (both directions present). out_perm[i] = old id at new position i.
int glass_rcm(const int64_t* row, const int64_t* col, int64_t e, int64_t n,
              int64_t* out_perm) {
  std::vector<int64_t> ptr(n + 1, 0), adj(e);
  for (int64_t i = 0; i < e; ++i) ptr[row[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) ptr[i + 1] += ptr[i];
  {
    std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
    for (int64_t i = 0; i < e; ++i) adj[cur[row[i]]++] = col[i];
  }
  std::vector<int64_t> degree(n);
  for (int64_t i = 0; i < n; ++i) {
    degree[i] = ptr[i + 1] - ptr[i];
    // sort each adjacency by degree for the classic CM tie-break
  }
  for (int64_t i = 0; i < n; ++i) {
    std::sort(adj.begin() + ptr[i], adj.begin() + ptr[i + 1],
              [&](int64_t a, int64_t b) { return degree[a] < degree[b]; });
  }
  std::vector<char> seen(n, 0);
  std::vector<int64_t> result;
  result.reserve(n);
  // process components, seeding each from its minimum-degree unseen node
  std::vector<int64_t> by_degree(n);
  std::iota(by_degree.begin(), by_degree.end(), 0);
  std::sort(by_degree.begin(), by_degree.end(),
            [&](int64_t a, int64_t b) { return degree[a] < degree[b]; });
  std::queue<int64_t> q;
  for (int64_t s : by_degree) {
    if (seen[s]) continue;
    seen[s] = 1;
    q.push(s);
    while (!q.empty()) {
      int64_t u = q.front();
      q.pop();
      result.push_back(u);
      for (int64_t k = ptr[u]; k < ptr[u + 1]; ++k) {
        int64_t v = adj[k];
        if (!seen[v]) {
          seen[v] = 1;
          q.push(v);
        }
      }
    }
  }
  // reverse
  for (int64_t i = 0; i < n; ++i) out_perm[i] = result[n - 1 - i];
  return 0;
}

// Samples e_neg directed non-edges (a, b), a != b, absent from the edge set.
// Deterministic under `seed`. Returns 0 on success, 1 if the graph is too
// dense to find enough negatives.
int glass_negative_sample(const int64_t* row, const int64_t* col, int64_t e,
                          int64_t n, int64_t e_neg, uint64_t seed,
                          int64_t* out_src, int64_t* out_dst) {
  std::unordered_set<int64_t> existing;
  existing.reserve(static_cast<size_t>(e * 2));
  for (int64_t i = 0; i < e; ++i) existing.insert(row[i] * n + col[i]);
  std::mt19937_64 gen(seed);
  std::uniform_int_distribution<int64_t> dist(0, n - 1);
  int64_t got = 0;
  int64_t attempts = 0;
  const int64_t max_attempts = e_neg * 1000 + 1000000;
  while (got < e_neg && attempts < max_attempts) {
    ++attempts;
    const int64_t a = dist(gen), b = dist(gen);
    if (a == b) continue;
    const int64_t key = a * n + b;
    if (existing.count(key)) continue;
    existing.insert(key);
    out_src[got] = a;
    out_dst[got] = b;
    ++got;
  }
  return got == e_neg ? 0 : 1;
}

// Induced-subgraph extraction for GNN-seg: for each padded subgraph row
// (pos, width L, pad -1), emits the dense local adjacency (L x L float32,
// 1.0 per directed edge) into out_adj[s].
int glass_induced_subgraphs(const int64_t* row, const int64_t* col, int64_t e,
                            int64_t n, const int64_t* pos, int64_t s_count,
                            int64_t width, float* out_adj) {
  // CSR of the global graph for neighbor queries
  std::vector<int64_t> ptr(n + 1, 0), adj(e);
  for (int64_t i = 0; i < e; ++i) ptr[row[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) ptr[i + 1] += ptr[i];
  {
    std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
    for (int64_t i = 0; i < e; ++i) adj[cur[row[i]]++] = col[i];
  }
  std::vector<int64_t> local(n, -1);
  for (int64_t s = 0; s < s_count; ++s) {
    const int64_t* nodes = pos + s * width;
    int64_t k = 0;
    for (; k < width && nodes[k] >= 0; ++k) local[nodes[k]] = k;
    float* a = out_adj + s * width * width;
    for (int64_t j = 0; j < k; ++j) {
      const int64_t u = nodes[j];
      for (int64_t p = ptr[u]; p < ptr[u + 1]; ++p) {
        const int64_t lv = local[adj[p]];
        if (lv >= 0) a[j * width + lv] += 1.0f;
      }
    }
    for (int64_t j = 0; j < k; ++j) local[nodes[j]] = -1;
  }
  return 0;
}

// Banded-slab fill for the Pallas band layout (ops/pallas_band.py):
// out[g, row - g*rps*128, col - clo[g]*128] += w, accumulated in double
// (matching the numpy builder's f64 bincount) and written as f32. Inputs
// are the nonzero-weight COO arrays; the caller sizes out as
// n_g * (rps*128) * (wb*128) floats. One sequential pass => deterministic.
int glass_band_fill(const int64_t* row, const int64_t* col, const double* w,
                    int64_t e, int64_t rps, int64_t wb, const int32_t* clo,
                    int64_t n_g, float* out) {
  const int64_t rows_per_g = rps * 128;
  const int64_t slab_cols = wb * 128;
  const int64_t slab_sz = rows_per_g * slab_cols;
  // Row-sorted inputs (the builder's normal case) fill in parallel: each
  // thread owns a contiguous GROUP range and sums one group at a time into
  // an accumulator of one slab, so every slot is summed by one thread in
  // original edge order, bit-identical to the sequential pass (f64
  // accumulation order per slot unchanged), without an f64 copy of the
  // whole layout.
  bool sorted = true;
  for (int64_t i = 1; i < e; ++i) {
    if (row[i] < row[i - 1]) { sorted = false; break; }
  }
  int bad = 0;
  if (sorted && e > 0) {
#pragma omp parallel reduction(|| : bad)
    {
#ifdef _OPENMP
      const int T = omp_get_num_threads();
      const int t = omp_get_thread_num();
#else
      const int T = 1, t = 0;
#endif
      const int64_t g_lo = n_g * t / T, g_hi = n_g * (t + 1) / T;
      std::vector<double> acc(g_lo < g_hi ? static_cast<size_t>(slab_sz) : 0);
      const int64_t* p = std::lower_bound(row, row + e, g_lo * rows_per_g);
      for (int64_t g = g_lo; g < g_hi && !bad; ++g) {
        std::fill(acc.begin(), acc.end(), 0.0);
        const int64_t* end =
            std::lower_bound(p, row + e, (g + 1) * rows_per_g);
        for (int64_t i = p - row; i < end - row; ++i) {
          const int64_t lr = row[i] - g * rows_per_g;
          const int64_t lc = col[i] - static_cast<int64_t>(clo[g]) * 128;
          if (lr < 0 || lr >= rows_per_g || lc < 0 || lc >= slab_cols) {
            bad = 1;
            break;
          }
          acc[lr * slab_cols + lc] += w[i];
        }
        p = end;
        float* o = out + g * slab_sz;
        for (int64_t k = 0; k < slab_sz; ++k) o[k] = static_cast<float>(acc[k]);
      }
    }
    return bad ? 1 : 0;
  }
  std::vector<double> acc(static_cast<size_t>(n_g) * slab_sz, 0.0);
  for (int64_t i = 0; i < e; ++i) {
    const int64_t g = (row[i] / 128) / rps;
    if (g < 0 || g >= n_g) return 1;
    const int64_t lr = row[i] - g * rows_per_g;
    const int64_t lc = col[i] - static_cast<int64_t>(clo[g]) * 128;
    if (lr < 0 || lr >= rows_per_g || lc < 0 || lc >= slab_cols) return 1;
    acc[g * slab_sz + lr * slab_cols + lc] += w[i];
  }
  const int64_t total = n_g * slab_sz;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < total; ++i) out[i] = static_cast<float>(acc[i]);
  return 0;
}

// Wide-chunk BCSR block fill (ops/pallas_spmm.py): each edge lands in its
// block's destination slot e_dst[i] (caller-computed, sorted-by-block
// order): out[e_dst/chunk][row%128][(e_dst%chunk)*128 + col%128] += w.
// f64 accumulation, f32 output — bit-matching the numpy bincount fallback.
int glass_bcsr_fill(const int64_t* row, const int64_t* col, const double* w,
                    const int64_t* e_dst, int64_t e, int64_t chunk,
                    int64_t n_store, float* out) {
  const int64_t store_cols = chunk * 128;
  const int64_t store_sz = 128 * store_cols;
  std::vector<double> acc(static_cast<size_t>(n_store) * store_sz, 0.0);
  for (int64_t i = 0; i < e; ++i) {
    const int64_t st = e_dst[i] / chunk;
    if (st < 0 || st >= n_store) return 1;
    acc[st * store_sz + (row[i] % 128) * store_cols
        + (e_dst[i] % chunk) * 128 + (col[i] % 128)] += w[i];
  }
  const int64_t total = n_store * store_sz;
  for (int64_t i = 0; i < total; ++i) out[i] = static_cast<float>(acc[i]);
  return 0;
}

}  // extern "C"

"""Host-side graph partitioning for the graph axis (counterpart of
``glass_tpu/parallel/partition.py``, whose host arrays these equal).

Nodes are split into K contiguous blocks of nb = ceil(N/K) nodes; block k
owns global nodes [k*nb, (k+1)*nb) (the last block is padded). Shard k
receives every directed edge whose destination lies in its block, with the
row localized and the column kept global (columns index the all-gathered
features, ``ops/spmm.py::gather_global``). The per-shard arrays are padded
to one shape and stacked on a leading shard axis, as the JAX package stacks
them for ``shard_map``; here each rank takes its own shard with
``local_graph(k, ...)`` and moves only that shard to its device.

The per-shard block-sparse layouts (``materialize_bcsr=True``) are
rectangular: forward local rows x global columns, transposed global rows x
local columns (the backward's dx = A_local^T g, reduce-scattered to the
blocks). The transposed band layouts are row-range trimmed to the groups
around the shard's columns. Each shard's int8 scales come from its own
rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from glass_tpu_torch.ops import band_spmm as bd
from glass_tpu_torch.ops import graph as tg
from glass_tpu_torch.ops._common import BLOCK
from glass_tpu_torch.ops.bcsr_spmm import (BCSR, bcsr_from_arrays,
                                           build_bcsr_arrays, pad_bcsr_arrays)
from glass_tpu_torch.ops.graph import Graph, normalized_edge_weight


def _stack(parts: list, key: str):
    """The parts' ``key`` arrays (numpy or CPU tensors) on a leading shard
    axis."""
    vals = [p[key] for p in parts]
    if isinstance(vals[0], torch.Tensor):
        return torch.stack(vals)
    return np.stack(vals)


@dataclasses.dataclass(frozen=True)
class StackedBCSR:
    """K per-shard BCSR layouts stacked on a leading shard axis, padded to
    one shape (``ops/bcsr_spmm.py::pad_bcsr_arrays``). Forward layouts are
    local rows x global columns; transposed layouts the mirror. Each layout
    has one appended all-zero row block, the padding chunks' target.
    ``blocks`` is a CPU tensor (numpy has no bf16), the tables numpy."""

    blocks: torch.Tensor  # (K, n_store, BLOCK, CHUNK*BLOCK)
    block_col: np.ndarray  # (K, nnz_b)
    block_row_ptr: np.ndarray  # (K, n_rb + 1)
    block_row_end: np.ndarray  # (K, n_rb)
    chunk_start: np.ndarray  # (K, n_chunks)
    chunk_len: np.ndarray
    chunk_row: np.ndarray
    chunk_first: np.ndarray
    chunk_last: np.ndarray
    n_rb: int
    n_cb: int
    n_node: int  # real output rows of each local layout
    row_scale: Optional[np.ndarray] = None  # (K, n_rb*BLOCK) f32, int8 only

    def local(self, k: int, device="cuda") -> BCSR:
        """Shard k's layout on ``device``."""
        a = {f.name: getattr(self, f.name)[k]
             for f in dataclasses.fields(self)
             if not isinstance(getattr(self, f.name), int)
             and getattr(self, f.name) is not None}
        a.update(n_rb=self.n_rb, n_cb=self.n_cb)
        return bcsr_from_arrays(a, self.n_node, device)


@dataclasses.dataclass(frozen=True)
class StackedBand:
    """K per-shard banded-slab layouts stacked on a leading shard axis with
    one window width. Forward layouts are local rows x global columns;
    transposed layouts (global rows x local columns) are row-range trimmed
    (``trimmed``): each shard stores ``n_groups`` groups from its ``g_lo``.
    ``slabs`` and ``row_scale`` are CPU tensors, ``clo`` and ``g_lo``
    numpy."""

    slabs: torch.Tensor  # (K, n_g, rps*BLOCK, W*BLOCK)
    clo: np.ndarray  # (K, n_g) int32 window starts
    g_lo: np.ndarray  # (K,) int32 first stored group (zeros untrimmed)
    n_rb: int
    n_cb: int
    n_node: int  # real output rows of each local layout
    rps: int
    w_blocks: int
    n_g_total: int
    trimmed: bool
    row_scale: Optional[torch.Tensor] = None  # (K, n_g*rps*BLOCK), int8

    def local(self, k: int, device="cuda") -> bd.BandedAdj:
        """Shard k's layout on ``device``."""
        a = dict(slabs=self.slabs[k], clo=self.clo[k], n_rb=self.n_rb,
                 n_cb=self.n_cb, w_blocks=self.w_blocks,
                 g_lo=int(self.g_lo[k]), n_g_total=self.n_g_total,
                 row_scale=(None if self.row_scale is None
                            else self.row_scale[k]))
        return bd.band_from_arrays(a, self.n_node, self.rps, device,
                                   trimmed=self.trimmed)


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Stacked per-shard arrays, leading dim = K shards.

    Built with ``overlap=True``, the edges whose source lies in the owning
    shard's own block are split out into loc_* with local column ids: they
    need no communication."""

    row: np.ndarray  # (K, E_shard) local destination rows (off-block edges)
    col: np.ndarray  # (K, E_shard) global source columns
    weight: np.ndarray  # (K, E_shard)
    dense: Optional[np.ndarray]  # (K, nb, K*nb) row blocks of the adjacency
    n_shards: int
    block: int  # nodes per shard (padded)
    n_node: int  # real global node count
    n_edge: int  # real global directed edge count
    aggr: str
    loc_row: Optional[np.ndarray] = None  # (K, E_loc) own-block edges
    loc_col: Optional[np.ndarray] = None  # (K, E_loc) local column ids
    loc_weight: Optional[np.ndarray] = None
    # ring halo buckets: [k, s] = edges of shard k sourced in block
    # (k+s+1) % K, columns local to that block
    ring_row: Optional[np.ndarray] = None  # (K, K-1, E_ring)
    ring_col: Optional[np.ndarray] = None
    ring_weight: Optional[np.ndarray] = None
    bcsr: Optional[StackedBCSR] = None
    bcsr_t: Optional[StackedBCSR] = None
    band: Optional[StackedBand] = None
    band_t: Optional[StackedBand] = None

    def local_graph(self, k: int, axis=None, device="cuda") -> Graph:
        """Shard k's :class:`Graph` on ``device``, sharded over ``axis``
        (the graph axis's process group; None for a one-shard partition
        without a process group)."""
        def t(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a[k])).to(device)

        def idx(a):
            return None if a is None else t(a).long()

        def layout(st):
            return None if st is None else st.local(k, device)

        return Graph(
            row=idx(self.row), col=idx(self.col), weight=t(self.weight),
            dense=t(self.dense), n_node=self.block, n_edge=self.n_edge,
            aggr=self.aggr, axis=axis, n_node_global=self.n_node,
            loc_row=idx(self.loc_row), loc_col=idx(self.loc_col),
            loc_weight=t(self.loc_weight), ring_row=idx(self.ring_row),
            ring_col=idx(self.ring_col), ring_weight=t(self.ring_weight),
            bcsr=layout(self.bcsr), bcsr_t=layout(self.bcsr_t),
            band=layout(self.band), band_t=layout(self.band_t),
        )

    def pad_nodes(self, x: np.ndarray) -> np.ndarray:
        """A (N, ...) per-node array padded to (K*block, ...)."""
        pad = self.n_shards * self.block - x.shape[0]
        if pad == 0:
            return x
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))


def partition_graph(
    edge_index: np.ndarray,
    edge_weight: Optional[np.ndarray],
    n_node: int,
    aggr: str,
    n_shards: int,
    *,
    materialize_dense: bool = False,
    materialize_bcsr: bool = False,
    dense_dtype: str = "f32",
    edge_bucket: int = 256,
    overlap: bool = True,
    ring: bool = False,
    sparse_layout: str = "auto",
) -> PartitionedGraph:
    """Partitions a COO edge list into K destination-row blocks
    (``glass_tpu/parallel/partition.py::partition_graph``).

    The normalization is global, before the split, so every shard's weights
    equal the unsharded graph's. ``overlap`` splits the own-block edges
    into loc_*; ``ring`` (which needs ``overlap``) buckets the others by
    source block for the ring halo exchange. ``sparse_layout`` ("auto" |
    "bcsr" | "band" | "hybrid", with ``materialize_bcsr``): the per-shard
    layout; "auto" scores stacked band, hybrid and BCSR with the layout
    planner's cost model (``ops/graph.py``) and keeps the cheapest.
    """
    if ring and not overlap:
        raise ValueError("ring=True requires overlap=True (own-block split)")
    edge_index = np.asarray(edge_index)
    n_edge = edge_index.shape[1]
    if edge_weight is None:
        edge_weight = np.ones(n_edge, dtype=np.float32)
    w = normalized_edge_weight(edge_index, edge_weight, n_node, aggr)

    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    # np.lexsort((col, row))'s order, from one stable sort of one key
    order = np.argsort(row * max(n_node, 1) + col, kind="stable")
    row, col, w = row[order], col[order], w[order]

    nb = -(-n_node // n_shards)  # block size
    shard_of = row // nb
    is_local = overlap & (col // nb == shard_of)

    def bucketize(sel_mask, local_cols: bool):
        counts = np.bincount(shard_of[sel_mask], minlength=n_shards)
        e_shard = max(edge_bucket, int(-(-max(counts.max(), 1) // edge_bucket)
                                       * edge_bucket))
        rows_ = np.full((n_shards, e_shard), nb - 1, dtype=np.int32)
        cols_ = np.zeros((n_shards, e_shard), dtype=np.int32)
        ws_ = np.zeros((n_shards, e_shard), dtype=np.float32)
        for k in range(n_shards):
            sel = sel_mask & (shard_of == k)
            c = int(sel.sum())
            rows_[k, :c] = (row[sel] - k * nb).astype(np.int32)
            csel = col[sel]
            if local_cols:
                csel = csel - k * nb
            cols_[k, :c] = csel.astype(np.int32)
            ws_[k, :c] = w[sel]
        return rows_, cols_, ws_

    if overlap:
        rows, cols, ws = bucketize(~is_local, local_cols=False)
        lrows, lcols, lws = bucketize(is_local, local_cols=True)
    else:
        rows, cols, ws = bucketize(np.ones_like(shard_of, dtype=bool),
                                   local_cols=False)
        lrows = lcols = lws = None

    ring_rows = ring_cols = ring_ws = None
    if ring and n_shards > 1:
        ring_rows, ring_cols, ring_ws = _ring_buckets(
            row, col, w, shard_of, n_shards, nb, edge_bucket)

    dense = None
    if materialize_dense:
        dense = np.zeros((n_shards, nb, n_shards * nb), dtype=np.float32)
        for k in range(n_shards):
            sel = shard_of == k
            np.add.at(dense[k], (row[sel] - k * nb, col[sel]), w[sel])

    bcsr = bcsr_t = band = band_t = None
    if materialize_bcsr:
        plan = None
        if sparse_layout in ("auto", "band", "hybrid"):
            shards = _shard_split(row, col, w, shard_of, n_shards, nb)
            plan = _plan_stacked_layout(shards, n_shards, nb, dense_dtype,
                                        sparse_layout)
        elif sparse_layout != "bcsr":
            raise ValueError(
                f"unknown sparse_layout {sparse_layout!r} for partitioned "
                "graphs (use 'auto', 'bcsr', 'band', or 'hybrid')")
        if plan is not None and plan[0] == "band":
            band, band_t = _build_stacked_band(shards, n_shards, nb,
                                               dense_dtype, *plan[1:])
        elif plan is not None:
            band, band_t, bcsr, bcsr_t = _build_stacked_hybrid(
                shards, n_shards, nb, dense_dtype, *plan[1:])
        else:
            bcsr, bcsr_t = _build_stacked_bcsr(row, col, w, shard_of,
                                               n_shards, nb, dense_dtype)

    return PartitionedGraph(
        row=rows, col=cols, weight=ws, dense=dense,
        n_shards=n_shards, block=nb, n_node=n_node, n_edge=n_edge, aggr=aggr,
        loc_row=lrows, loc_col=lcols, loc_weight=lws,
        ring_row=ring_rows, ring_col=ring_cols, ring_weight=ring_ws,
        bcsr=bcsr, bcsr_t=bcsr_t, band=band, band_t=band_t,
    )


def _ring_buckets(row, col, w, shard_of, n_shards, nb, edge_bucket):
    """(K, K-1, E_ring) rows, columns (local to the source block) and
    weights: bucket [k, s-1] holds shard k's edges sourced in block
    (k+s) % K, padded to one bucket size."""
    src_of = col // nb
    counts = np.zeros((n_shards, n_shards - 1), dtype=np.int64)
    for k in range(n_shards):
        for s in range(1, n_shards):
            j = (k + s) % n_shards
            counts[k, s - 1] = int(((shard_of == k) & (src_of == j)).sum())
    e_ring = max(edge_bucket,
                 int(-(-max(int(counts.max()), 1) // edge_bucket)
                     * edge_bucket))
    shape = (n_shards, n_shards - 1, e_ring)
    ring_rows = np.full(shape, nb - 1, np.int32)
    ring_cols = np.zeros(shape, np.int32)
    ring_ws = np.zeros(shape, np.float32)
    for k in range(n_shards):
        for s in range(1, n_shards):
            j = (k + s) % n_shards
            sel = (shard_of == k) & (src_of == j)
            c = int(sel.sum())
            ring_rows[k, s - 1, :c] = (row[sel] - k * nb).astype(np.int32)
            ring_cols[k, s - 1, :c] = (col[sel] - j * nb).astype(np.int32)
            ring_ws[k, s - 1, :c] = w[sel]
    return ring_rows, ring_cols, ring_ws


def _shard_split(row, col, w, shard_of, n_shards, nb):
    """Per-shard nonzero edges in both sort orders: row-sorted ``(r, c,
    w)`` (the input is row-sorted, so each shard's slice is) and
    column-sorted ``(c_s, r_s, w_s)`` for the transposed direction, with
    their block ids (``rb``, ``cb``; ``rb_s``, ``cb_s``)."""
    keep = np.asarray(w) != 0
    shards = []
    for k in range(n_shards):
        sel = keep & (shard_of == k)
        r, c, wk = row[sel] - k * nb, col[sel], w[sel]
        cs = np.argsort(c, kind="stable")
        sh = dict(r=r, c=c, w=wk, c_s=c[cs], r_s=r[cs], w_s=wk[cs])
        sh.update(rb=(r // BLOCK).astype(np.int32),
                  cb=(c // BLOCK).astype(np.int32))
        sh.update(rb_s=sh["rb"][cs], cb_s=sh["cb"][cs])
        shards.append(sh)
    return shards


def _histograms(s, nb, n_glob):
    """A shard's per-(row block, column block) edge counts in both
    directions (``band_spmm.block_histogram``), computed once."""
    if "hist_f" not in s:
        keep = np.ones(s["r"].size, dtype=bool)
        s["hist_f"] = bd.block_histogram(s["r"], s["c"], keep, nb,
                                         n_col=n_glob)
        s["hist_t"] = bd.block_histogram(s["c_s"], s["r_s"], keep, n_glob,
                                         n_col=nb)
    return s["hist_f"], s["hist_t"]


def _hybrid_masks(s, rps, w_f, w_t, nb, n_glob, transposed: bool = True):
    """A shard's hybrid split at forced widths: each group's best window in
    both directions (forward: local rows x global columns; transposed: the
    mirror) and the in-band mask, inside both windows, so that the forward
    and the transposed band layouts hold one matrix. Returns (in-band on
    the row-sorted edges, on the column-sorted edges (None without
    ``transposed``), clo_f, clo_t, the clamped widths)."""
    n_cb_glob = -(-n_glob // BLOCK)
    n_rb_loc = -(-nb // BLOCK)
    w_f = min(w_f, n_cb_glob)
    w_t = min(w_t, n_rb_loc)
    hist_f, hist_t = _histograms(s, nb, n_glob)
    clo_f, _ = bd.best_windows(bd.window_histogram_from_blocks(hist_f, rps),
                               w_f)
    clo_t, _ = bd.best_windows(bd.window_histogram_from_blocks(hist_t, rps),
                               w_t)

    def mask(rb, cb):
        lo_f = clo_f[rb // rps]
        lo_t = clo_t[cb // rps]
        return (cb >= lo_f) & (cb < lo_f + w_f) & (rb >= lo_t) \
            & (rb < lo_t + w_t)

    in_rc = mask(s["rb"], s["cb"])
    in_cs = mask(s["rb_s"], s["cb_s"]) if transposed else None
    return in_rc, in_cs, clo_f, clo_t, w_f, w_t


def _plan_stacked_layout(shards, n_shards, nb, dense_dtype,
                         sparse_layout: str):
    """The stacked block-sparse layout of a partitioned graph
    (``partition.py::_plan_stacked_layout``): None (stacked BCSR),
    ``("band", rps, w_fwd, w_bwd)`` or ``("hybrid", rps, w_fwd, w_bwd)``.
    Candidates are scored with the layout planner's cost model; the shards'
    costs are maxed, and the transposed layouts priced by their stored
    (trimmed) groups. Two of the port's terms (``ops/graph.py``): the
    card's fill (``_filled``) prices each slab stream by its layout's
    rows, as the unsharded planner does, and ``_STACKED_SLAB_ROWS`` prices
    a group's slab by its rps*128 rows; with both off the scores are the
    reference's."""
    band_step_s, _, stream_bps = tg._cost_constants()
    itemsize = 2 if dense_dtype == "bf16" else 4
    n_glob = n_shards * nb
    n_cb_glob = -(-n_glob // BLOCK)
    n_rb_loc = -(-nb // BLOCK)

    def slab_cost(n_steps, w):
        rate = tg._filled(stream_bps, n_steps * rps * BLOCK)
        rows = rps if tg._STACKED_SLAB_ROWS else 1
        return n_steps * (band_step_s
                          + rows * w * BLOCK * BLOCK * itemsize / rate)

    bcsr_total = max(
        tg._bcsr_cost_model(s["r"], s["c"], nb, itemsize, n_col=n_glob)
        + tg._bcsr_cost_model(s["c_s"], s["r_s"], n_glob, itemsize, n_col=nb)
        for s in shards
    ) if sparse_layout == "auto" else np.inf

    n_edges = sum(s["r"].size for s in shards)
    best_band = None  # (cost, rps, w_fwd, w_bwd)
    best_hybrid = None
    for rps in (1, 2, 4, 8, 16):
        n_g_f = -(-n_rb_loc // rps)
        n_g_total_t = -(-n_cb_glob // rps)
        w_f = w_t = 1
        store_t = 1
        spans_f, spans_t = [], []
        for s in shards:
            lo, hi = bd._group_minmax((s["r"] // BLOCK) // rps,
                                      s["c"] // BLOCK, n_g_f, n_cb_glob)
            sp = (hi - lo)[hi > 0]
            spans_f.append(sp)
            w_f = max(w_f, int(sp.max()) if sp.size else 1)
            lo, hi = bd._group_minmax((s["c_s"] // BLOCK) // rps,
                                      s["r_s"] // BLOCK, n_g_total_t,
                                      n_rb_loc)
            sp = (hi - lo)[hi > 0]
            spans_t.append(sp)
            w_t = max(w_t, int(sp.max()) if sp.size else 1)
            if s["c"].size:
                g = (s["c"] // BLOCK) // rps
                store_t = max(store_t, int(g.max() - g.min() + 1))
        w_f, w_t = min(w_f, n_cb_glob), min(w_t, n_rb_loc)
        store_t = min(store_t, n_g_total_t)
        if (sparse_layout != "hybrid"
                and bd.band_vmem_ok(rps, w_f, 128, itemsize)
                and bd.band_vmem_ok(rps, w_t, 128, itemsize)):
            cost = slab_cost(n_g_f, w_f) + slab_cost(store_t, w_t)
            if best_band is None or cost < best_band[0]:
                best_band = (cost, rps, w_f, w_t)
        # hybrid candidates: per-direction span quantiles and small fixed
        # widths, scored with the exact split
        if sparse_layout == "band" or rps > 8:
            continue
        sf = np.concatenate(spans_f) if spans_f else np.zeros(0, np.int64)
        st = np.concatenate(spans_t) if spans_t else np.zeros(0, np.int64)
        if sf.size == 0 or st.size == 0:
            continue
        cands = {(int(np.quantile(sf, q)), int(np.quantile(st, q)))
                 for q in (0.5, 0.9)} | {(4, 4), (8, 8)}
        for wfh, wth in sorted(cands):
            wfh, wth = min(max(wfh, 1), n_cb_glob), min(max(wth, 1), n_rb_loc)
            if (wfh, wth) == (w_f, w_t):
                continue  # that is the full band, scored above
            if not (bd.band_vmem_ok(rps, wfh, 128, itemsize)
                    and bd.band_vmem_ok(rps, wth, 128, itemsize)):
                continue
            covered = 0
            store_h = 1
            res_cost = 0.0
            for s in shards:
                in_rc, _, _, _, _, _ = _hybrid_masks(s, rps, wfh, wth, nb,
                                                     n_glob, transposed=False)
                covered += int(in_rc.sum())
                if in_rc.any():  # the in-band edges' column groups
                    g = s["cb"][in_rc] // rps
                    store_h = max(store_h, int(g.max() - g.min() + 1))
                out_r, out_c = s["r"][~in_rc], s["c"][~in_rc]
                res_cost = max(
                    res_cost,
                    tg._bcsr_cost_model(out_r, out_c, nb, itemsize,
                                        n_col=n_glob)
                    + tg._bcsr_cost_model(out_c, out_r, n_glob, itemsize,
                                          n_col=nb))
            if n_edges and covered / n_edges < 0.5:
                continue  # the band no longer carries the bulk
            cost = (slab_cost(n_g_f, wfh) + slab_cost(store_h, wth)
                    + res_cost)
            if best_hybrid is None or cost < best_hybrid[0]:
                best_hybrid = (cost, rps, wfh, wth)

    if sparse_layout == "band":
        if best_band is None:
            raise ValueError(
                "sparse_layout='band': no per-shard band window passes the "
                "layout rule for any rps: the partitioned profiles are too "
                "wide")
        return ("band",) + best_band[1:]
    if sparse_layout == "hybrid":
        if best_hybrid is None:
            raise ValueError(
                "sparse_layout='hybrid': no feasible per-shard hybrid window "
                "(the layout rule, or empty shards)")
        return ("hybrid",) + best_hybrid[1:]
    # auto: the cheapest of band, hybrid and BCSR; a hybrid must also beat
    # the best single layout by the margin (two kernels and an add)
    choices = []
    if best_band is not None:
        choices.append((best_band[0], ("band",) + best_band[1:]))
    if best_hybrid is not None and best_hybrid[0] < tg._HYBRID_MARGIN * min(
            [bcsr_total] + ([best_band[0]] if best_band else [])):
        choices.append((best_hybrid[0], ("hybrid",) + best_hybrid[1:]))
    choices = [c for c in choices if c[0] < bcsr_total]
    if not choices:
        return None
    return min(choices)[1]


def _slab_dtype(dense_dtype: str) -> str:
    return {"f32": "float32", "int8": "int8"}.get(dense_dtype, "bfloat16")


def _stack_band_parts(parts, n_rb, n_cb, n_node, rps, wb, n_g_total,
                      trimmed) -> StackedBand:
    return StackedBand(
        slabs=_stack(parts, "slabs"), clo=_stack(parts, "clo"),
        g_lo=np.asarray([p["g_lo"] for p in parts], dtype=np.int32),
        n_rb=n_rb, n_cb=n_cb, n_node=n_node, rps=rps, w_blocks=wb,
        n_g_total=n_g_total, trimmed=trimmed,
        row_scale=(_stack(parts, "row_scale")
                   if parts and parts[0]["row_scale"] is not None else None))


def _trim_start(cols, rps: int, n_g_store: int, n_g_total: int) -> int:
    """A transposed layout's first stored group: its lowest column group,
    moved down so that ``n_g_store`` groups fit."""
    g_lo = int(((cols // BLOCK) // rps).min()) if cols.size else 0
    return min(g_lo, n_g_total - n_g_store)


def _build_stacked_band(shards, n_shards, nb, dense_dtype, rps, w_fwd,
                        w_bwd):
    """The per-shard banded-slab layouts (StackedBand): forward local rows
    x global columns at width ``w_fwd``; transposed global rows x local
    columns at width ``w_bwd``, trimmed to one stored-group count."""
    bdtype = _slab_dtype(dense_dtype)
    n_glob = n_shards * nb
    n_rb_loc = -(-nb // BLOCK)
    n_cb_glob = -(-n_glob // BLOCK)
    n_g_total_t = -(-n_cb_glob // rps)

    spans = [1]
    for s in shards:
        if s["c"].size:
            g = (s["c"] // BLOCK) // rps
            spans.append(int(g.max() - g.min() + 1))
    n_g_store = min(max(spans), n_g_total_t)

    fwd_parts, bwd_parts = [], []
    for s in shards:
        r, c, wk = s["r"], s["c"], s["w"]
        clo_f = bd.window_starts(r, c, nb, rps, w_fwd, n_col=n_glob)
        fwd_parts.append(bd.build_band_arrays(
            r, c, wk, nb, rps, bdtype, window=(w_fwd, clo_f), n_col=n_glob))
        clo_t = bd.window_starts(s["c_s"], s["r_s"], n_glob, rps, w_bwd,
                                 n_col=nb)
        g_lo = _trim_start(c, rps, n_g_store, n_g_total_t)
        bwd_parts.append(bd.build_band_arrays(
            s["c_s"], s["r_s"], s["w_s"], n_glob, rps, bdtype,
            window=(w_bwd, clo_t), n_col=nb, trim_groups=(g_lo, n_g_store)))

    fwd = _stack_band_parts(fwd_parts, n_rb_loc, n_cb_glob, nb, rps, w_fwd,
                            -(-n_rb_loc // rps), trimmed=False)
    bwd = _stack_band_parts(bwd_parts, n_cb_glob, n_rb_loc, n_glob, rps,
                            w_bwd, n_g_total_t, trimmed=True)
    return fwd, bwd


def _build_stacked_hybrid(shards, n_shards, nb, dense_dtype, rps, w_f, w_t):
    """The per-shard hybrid split: banded slabs over per-group best windows
    of widths ``(w_f, w_t)`` for the in-band edges (inside both
    directions' windows), stacked BCSR over the residue. Returns (band,
    band_t, bcsr, bcsr_t)."""
    bdtype = _slab_dtype(dense_dtype)
    n_glob = n_shards * nb
    n_rb_loc = -(-nb // BLOCK)
    n_cb_glob = -(-n_glob // BLOCK)
    n_g_total_t = -(-n_cb_glob // rps)

    splits = [_hybrid_masks(s, rps, w_f, w_t, nb, n_glob) for s in shards]
    w_f = splits[0][4] if splits else w_f  # clamped widths
    w_t = splits[0][5] if splits else w_t

    n_g_store = 1
    for s, (_, in_cs, _, _, _, _) in zip(shards, splits):
        if in_cs.any():
            g = (s["c_s"][in_cs] // BLOCK) // rps
            n_g_store = max(n_g_store, int(g.max() - g.min() + 1))
    n_g_store = min(n_g_store, n_g_total_t)

    fwd_parts, bwd_parts = [], []
    res_r, res_c, res_w = [], [], []
    for k, (s, (in_rc, in_cs, clo_f, clo_t, _, _)) in enumerate(
            zip(shards, splits)):
        fwd_parts.append(bd.build_band_arrays(
            s["r"][in_rc], s["c"][in_rc], s["w"][in_rc], nb, rps, bdtype,
            window=(w_f, clo_f), n_col=n_glob))
        g_lo = _trim_start(s["c_s"][in_cs], rps, n_g_store, n_g_total_t)
        bwd_parts.append(bd.build_band_arrays(
            s["c_s"][in_cs], s["r_s"][in_cs], s["w_s"][in_cs], n_glob, rps,
            bdtype, window=(w_t, clo_t), n_col=nb,
            trim_groups=(g_lo, n_g_store)))
        out = ~in_rc
        res_r.append(s["r"][out] + k * nb)  # back to global rows
        res_c.append(s["c"][out])
        res_w.append(s["w"][out])

    band = _stack_band_parts(fwd_parts, n_rb_loc, n_cb_glob, nb, rps, w_f,
                             -(-n_rb_loc // rps), trimmed=False)
    band_t = _stack_band_parts(bwd_parts, n_cb_glob, n_rb_loc, n_glob, rps,
                               w_t, n_g_total_t, trimmed=True)
    rr = np.concatenate(res_r) if res_r else np.zeros(0, np.int64)
    rc = np.concatenate(res_c) if res_c else np.zeros(0, np.int64)
    rw = np.concatenate(res_w) if res_w else np.zeros(0, np.float32)
    bcsr, bcsr_t = _build_stacked_bcsr(rr, rc, rw, rr // nb, n_shards, nb,
                                       dense_dtype)
    return band, band_t, bcsr, bcsr_t


def _build_stacked_bcsr(row, col, w, shard_of, n_shards, nb, dense_dtype):
    """Per-shard rectangular BCSR layouts (forward: local rows x global
    columns; transposed: global rows x local columns), padded to one shape
    across shards. Each layout gets one appended zero row block
    (pad_row_blocks=1), the target of the cross-shard chunk padding."""
    bdtype = _slab_dtype(dense_dtype)
    n_glob = n_shards * nb
    fwd, bwd = [], []
    for k in range(n_shards):
        sel = shard_of == k
        r_l = (row[sel] - k * nb).astype(np.int64)
        c_g = col[sel].astype(np.int64)
        w_k = w[sel]
        fwd.append(build_bcsr_arrays(r_l, c_g, w_k, nb, bdtype, n_col=n_glob,
                                     pad_row_blocks=1))
        bwd.append(build_bcsr_arrays(c_g, r_l, w_k, n_glob, bdtype, n_col=nb,
                                     pad_row_blocks=1))

    def stack(parts, n_node):
        n_store = max(p["blocks"].shape[0] for p in parts)
        nnz_b = max(p["block_col"].shape[0] for p in parts)
        n_chunks = max(p["chunk_start"].shape[0] for p in parts)
        parts = [pad_bcsr_arrays(p, n_store, nnz_b, n_chunks) for p in parts]
        names = ("blocks", "block_col", "block_row_ptr", "block_row_end",
                 "chunk_start", "chunk_len", "chunk_row", "chunk_first",
                 "chunk_last")
        return StackedBCSR(
            **{name: _stack(parts, name) for name in names},
            n_rb=parts[0]["n_rb"], n_cb=parts[0]["n_cb"], n_node=n_node,
            row_scale=(_stack(parts, "row_scale")
                       if parts[0]["row_scale"] is not None else None))

    return stack(fwd, nb), stack(bwd, n_glob)

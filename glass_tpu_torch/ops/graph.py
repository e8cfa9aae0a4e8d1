"""Graph container, normalized-adjacency construction and the layout
planner.

Counterpart of ``glass_tpu/ops/graph.py``. The normalization is computed on
the host, in the native library (``glass_tpu_torch/native.py``) or in
numpy where it is unbuilt, exactly as the JAX package does it:

  deg[i]   = sum_j w[i, j]           (row sums of the weighted adjacency)
  deg[deg < 0.5] += 1                (isolated-node guard)
  mean     : w'_ij = w_ij / deg[i]
  sum      : w'_ij = w_ij
  gcn      : w'_ij = deg[i]^-1/2 * w_ij * deg[j]^-1/2

and the matvec convention is out[row] += w' * x[col] (``A @ x`` with
edge_index[0] the row). Edges are sorted by (row, col) and padded to a
multiple of ``EDGE_BUCKET`` with zero-weight edges on the last node, so the
edge arrays equal the JAX builder's.

Of the adjacency layouts, this port builds the dense matrix (f32 or bf16),
the row-quantized int8 dense layout (``ops/dense_q.py``), the chunked BCSR
layout (``ops/bcsr_spmm.py``), the banded slabs (``ops/band_spmm.py``) and
the hybrid split of the two, at the JAX builder's dtypes for each
``dense_dtype``. Which one ``sparse_layout="auto"`` builds is the layout
planner's choice (:func:`_plan_block_sparse` and the dense and segment
candidates of :func:`build_graph`), ported with its cost model; the
model's constants are the H100's, and two of its terms are the card's own
(the fill of the card and the dense candidate's price; see the constants
below).
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from glass_tpu_torch import native
from glass_tpu_torch.ops import band_spmm as bd
from glass_tpu_torch.ops._common import BLOCK, resolve_device
from glass_tpu_torch.ops.bcsr_spmm import (CHUNK, BCSR, BlockPattern,
                                           block_pattern, build_bcsr,
                                           coo_is_symmetric)
from glass_tpu_torch.ops.dense_q import DenseQ, build_dense_q, dense_q_vmem_ok

# Edge padding bucket (the JAX package pads to keep compiled shapes few; the
# port pads the same way so that its edge arrays equal the JAX builder's).
EDGE_BUCKET = 1024

# Default max node count for which the dense adjacency is materialized
# (n^2 float32 <= 256 MiB at 8192).
DENSE_NODE_LIMIT = 8192

DENSE_DTYPES = ("f32", "bf16", "int8")
SPARSE_LAYOUTS = ("auto", "bcsr", "band", "hybrid")

# The planner's cost model, t = n_steps * step_cost + streamed_bytes /
# stream_bps, with constants fitted on an "NVIDIA H100 80GB HBM3, 700.00 W"
# (nvidia-smi name, power.limit) by tools/torch_autotune.py: the band
# kernel's per-group cost and slab rate, the BCSR kernel's per-chunk cost
# (the residual after the stream term), both of the port's f32 kernels at
# H = 64, timed on a busy card (ops/autotune.py). The card runs groups side
# by side, so a step costs nanoseconds where the TPU's cost microseconds,
# and the ranking follows the stored bytes. The slab rate is the f32 band
# kernel's own (3xTF32 on the tensor cores), not the memory's: the HBM read
# probe (tools/torch_hbm_probe.py) measures about twice as much. The BCSR
# chunk cost is what the f32 BCSR kernel (3xTF32 over the live blocks, the
# band's stages) takes beyond that rate on its live blocks. Fitted on the
# kernels of csrc/ as they are: refit after any change to the f32 band or
# BCSR kernel. The planner reads GLASS_TPU_AUTOTUNE's file in their place
# when the variable is set (the JAX package's three-key format: one file
# serves both packages).
_BAND_STEP_COST_S = 9.638e-9
_BCSR_STEP_COST_S = 3.680e-9
_BAND_STREAM_BPS = 1.563e12
# The card's fill, a term the reference's model does not have: a layout
# with fewer 128-row blocks than this leaves SMs idle, so its bytes stream
# at the rate times row_blocks / _CARD_ROW_BLOCKS. The f32 band kernel runs
# one CTA per row block (at H = 64); BCSR and the bf16/int8 band run
# persistent CTAs (grid = min(SMs, row blocks), two an SM for f32 BCSR),
# whose fill below this many row blocks this one constant prices too,
# unmeasured. Measured on the same card by chip_smoke.py [planner_rates]
# (the f32 band kernel alone, one launch at a time against a busy card; the
# median of 155.8, 167.9 and 173.5). 0 turns the term off, as in the
# reference.
_CARD_ROW_BLOCKS = 168
# The dense candidate's matrix rate: torch.matmul of the (n, n) adjacency
# with (n, 128) x at the hpo shape (n = 14,587), f32 with TF32 off and bf16,
# on the same card by chip_smoke.py [planner_rates]. That rate is the whole
# call's, the matrix's reads included, so the port prices the dense
# candidate by it alone; _DENSE_BYTE_TERM = True adds the reference's
# streamed-bytes term on top.
_MXU_FLOPS = {"bf16": 1.274e14, "f32": 4.683e13}
_DENSE_BYTE_TERM = False
# The int8 dense candidate's rate: the int8 dense kernel (csrc/dense_q_spmm.cu)
# on an (n, n) layout with (n, 128) x at the hpo shape, as 2 n^2 128 / time,
# on the same card by chip_smoke.py [planner_rates]. The port prices
# dense_dtype "int8" by it where the int8 layout's rule holds (the layout
# build_graph then builds); the reference prices it as a bf16 matmul, as the
# port does with _DENSE_BYTE_TERM.
_DENSE_Q_FLOPS = 2.287e14
# The segment candidate's rate: the "segment" SpMM (gather, index_add_) at
# the em_user shape (9M directed edges, H = 128), counted as the model
# counts it, 2 * (16 + 128 * 4) bytes per edge; same card, same phase.
_GATHER_BPS = 5.421e11
# The BCSR kernel reads each row block's nonzero blocks only and skips the
# CHUNK padding after them (ops/bcsr_spmm.py's block_row_end), so the port
# prices the live blocks; False prices every stored block, padding
# included, as the reference's model does.
_BCSR_LIVE_BLOCKS = True
# Memory caps by the JAX comment's rule (glass_tpu/ops/graph.py:510-521),
# for the H100's 80 GiB: the dense adjacency at most an eighth of the card
# (2 GiB of the v5e's 16), a stored block-sparse layout at most a quarter,
# so that its two directions leave half the card to the activations.
_DENSE_MXU_BYTES_CAP = 10 << 30
_LAYOUT_BYTES_CAP = 20 << 30
# A hybrid split must beat the best single layout by this factor to justify
# running two kernels (two outputs and an add).
_HYBRID_MARGIN = 0.9
H_PAD = 128  # the hidden width the model prices: GLASS's widths pad to it
# The per-shard band's slab bytes (parallel/partition.py): a group's slab
# is rps*128 rows by w*128 columns. The reference's stacked planner prices
# w*128*128 bytes a group whatever rps (glass_tpu/parallel/partition.py:
# 466-468), so a tall group looks rps times cheaper than it is, and the
# em_user stand-in's shards get rps 8 with 10-block windows where rps 1
# needs 3; False prices as the reference does.
_STACKED_SLAB_ROWS = True


@dataclass(frozen=True)
class Graph:
    """A normalized graph on one device.

    Attributes:
      row:    (E_pad,) int64, destination node of each directed edge,
              ascending.
      col:    (E_pad,) int64, source node of each directed edge.
      weight: (E_pad,) float32 normalized edge weight; 0.0 on padding edges.
      dense:  optional (n_node, n_node) dense normalized adjacency, float32
              or (dense_dtype "bf16", or "int8" past the int8 layout rule)
              bfloat16.
      n_node: node count.
      n_edge: real (unpadded) directed edge count.
      aggr:   which normalization was applied ("mean" | "sum" | "gcn").
      bcsr:   optional chunked-BCSR layout of A for the "pallas" SpMM mode
              (with ``band``: the out-of-window residue of a hybrid split).
      bcsr_t: the layout of A^T (the same object when A is symmetric), for
              the backward pass.
      band:   optional banded-slab layout of A for the "band" and "pallas"
              SpMM modes.
      band_t: the banded layout of A^T (the same object when A is
              symmetric), for the backward pass.
      dense_q: optional row-quantized int8 dense layout of A (dense_dtype
              "int8"), in place of ``dense``.
      dense_q_t: the int8 layout of A^T (the same object when A is
              symmetric), for the backward pass.
      plan:   the layout the planner chose for ``sparse_layout="auto"``
              ("band", "bcsr", "hybrid", "dense" or "segment"); None when the caller forced a layout
              or built none. The "pallas" SpMM mode follows it to the dense
              or segment path.

    Sharded graphs (``parallel/partition.py``; ``glass_tpu/ops/graph.py``'s
    sharding model): nodes are split into K contiguous blocks of
    ``n_node`` = ceil(N / K) rows, the last one padded, and this graph is
    one block. ``axis`` is the graph axis's process group (``None``
    unsharded), ``row`` holds local rows and ``col`` global columns, which
    index the features all-gathered over ``axis``; ``dense`` is the
    block's (n_node, K * n_node) rows; the block-sparse layouts are
    rectangular (local rows x global columns forward, the mirror
    transposed). ``loc_*`` hold the edges sourced in the block itself, with
    local columns (the overlap split; ``row``/``col``/``weight`` then hold
    the others), and ``ring_*`` the (K-1, E_ring) buckets of the ring halo
    exchange: bucket s holds the edges sourced in block (k + s + 1) % K,
    with columns local to that block.
    """

    row: torch.Tensor
    col: torch.Tensor
    weight: torch.Tensor
    dense: Optional[torch.Tensor]
    n_node: int
    n_edge: int
    aggr: str = "sum"
    bcsr: Optional[BCSR] = None
    bcsr_t: Optional[BCSR] = None
    band: Optional[bd.BandedAdj] = None
    band_t: Optional[bd.BandedAdj] = None
    dense_q: Optional[DenseQ] = None
    dense_q_t: Optional[DenseQ] = None
    plan: Optional[str] = None
    axis: Optional[object] = None  # torch.distributed process group
    n_node_global: int = 0
    loc_row: Optional[torch.Tensor] = None
    loc_col: Optional[torch.Tensor] = None
    loc_weight: Optional[torch.Tensor] = None
    ring_row: Optional[torch.Tensor] = None  # (K-1, E_ring)
    ring_col: Optional[torch.Tensor] = None
    ring_weight: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.row.device

    @property
    def n_global(self) -> int:
        """Global node count (sharded and unsharded graphs)."""
        return self.n_node_global if self.axis is not None else self.n_node

    def node_offset(self) -> int:
        """This block's first global node id (0 when unsharded)."""
        if self.axis is None:
            return 0
        return torch.distributed.get_rank(self.axis) * self.n_node

    def node_mask(self) -> Optional[torch.Tensor]:
        """(n_node,) bool marking real (non-padding) rows; None if all are
        real."""
        if self.axis is None:
            return None
        ids = self.node_offset() + torch.arange(self.n_node,
                                                device=self.device)
        return ids < self.n_node_global

    def node_rows(self) -> Optional[tuple]:
        """(first global row, global rows) of this block, for draws that
        must not depend on the sharding (``nn/dropout.py``); None when
        unsharded."""
        if self.axis is None:
            return None
        return self.node_offset(), self.n_node_global


def normalized_edge_weight(
    edge_index: np.ndarray,
    edge_weight: np.ndarray,
    n_node: int,
    aggr: str,
) -> np.ndarray:
    """Host-side computation of the normalized edge weights (see module doc)."""
    row, col = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    w = np.asarray(edge_weight, dtype=np.float64)
    # astype: bincount of no edges returns int64 even with weights
    deg = np.bincount(row, weights=w, minlength=n_node).astype(np.float64)
    deg[deg < 0.5] += 1.0
    if aggr == "mean":
        return (w / deg[row]).astype(np.float32)
    if aggr == "sum":
        return w.astype(np.float32)
    if aggr == "gcn":
        dinv = deg**-0.5
        return (dinv[row] * w * dinv[col]).astype(np.float32)
    raise NotImplementedError(f"unknown aggr {aggr!r}")


# ---------------------------------------------------------------- planner


def _cost_constants() -> tuple:
    """(band_step_s, bcsr_step_s, stream_bps): the module's constants, or
    the file named by GLASS_TPU_AUTOTUNE (read per call, parsed once per
    path), as ``glass_tpu/ops/graph.py::_cost_constants``."""
    path = os.environ.get("GLASS_TPU_AUTOTUNE")
    if path:
        return _load_cost_file(path)
    return _BAND_STEP_COST_S, _BCSR_STEP_COST_S, _BAND_STREAM_BPS


@functools.lru_cache(maxsize=8)
def _load_cost_file(path: str) -> tuple:
    try:
        with open(path) as f:
            d = json.load(f)
        return (float(d["band_step_cost_s"]), float(d["bcsr_step_cost_s"]),
                float(d["stream_bps"]))
    except (OSError, KeyError, ValueError, TypeError) as e:
        raise ValueError(
            f"GLASS_TPU_AUTOTUNE={path} is not a valid autotune file "
            f"(expected keys band_step_cost_s/bcsr_step_cost_s/"
            f"stream_bps): {e}") from e


def _layout_bytes_cap() -> int:
    """GLASS_TPU_LAYOUT_BYTES_CAP_GIB overrides ``_LAYOUT_BYTES_CAP``."""
    gib = os.environ.get("GLASS_TPU_LAYOUT_BYTES_CAP_GIB")
    return int(float(gib) * (1 << 30)) if gib else _LAYOUT_BYTES_CAP


def _filled(stream_bps: float, n_node: int) -> float:
    """The slab rate of a layout over ``n_node`` rows: ``stream_bps`` times
    the card's fill, min(1, row blocks / _CARD_ROW_BLOCKS); ``stream_bps``
    itself when the term is off."""
    if _CARD_ROW_BLOCKS <= 0:
        return stream_bps
    return stream_bps * min(1.0, -(-n_node // BLOCK) / _CARD_ROW_BLOCKS)


def _bcsr_cost_model(row, col, n_node: int, itemsize: int,
                     n_col: Optional[int] = None,
                     pattern: Optional[BlockPattern] = None) -> float:
    """Modeled chunked-BCSR time of a (nonzero) COO pattern: a fixed cost
    per chunk (every empty row block still costs its placeholder chunk) and
    the blocks streamed: the live ones (``_BCSR_LIVE_BLOCKS``), or every
    stored one, CHUNK padding included. ``n_col``: the column count of a
    rectangular (per-shard) pattern, square by default; ``pattern``: the
    edges' :class:`BlockPattern` in their place. Copy of
    ``glass_tpu/ops/graph.py::_bcsr_cost_model``, with the card's fill and
    the live-block term."""
    _, bcsr_step_s, stream_bps = _cost_constants()
    stream_bps = _filled(stream_bps, n_node)
    n_rb = -(-n_node // BLOCK)
    n_cb = -(-(n_col if n_col is not None else n_node) // BLOCK)
    if pattern is None:
        pattern = block_pattern(row, col, None, n_rb, n_cb)
    if pattern.n_blocks == 0:
        return n_rb * bcsr_step_s
    cnt = np.diff(pattern.ptr)
    chunks = int(np.maximum(-(-cnt // CHUNK), 1).sum())
    stored = int(cnt.sum() if _BCSR_LIVE_BLOCKS
                 else (-(-cnt // CHUNK) * CHUNK).sum())
    return chunks * bcsr_step_s + stored * BLOCK * BLOCK * itemsize / stream_bps


def _pattern_spans(pattern: BlockPattern) -> tuple:
    """``band_spmm.rowblock_spans`` of the pattern's edges: each row
    block's (first column block, last + 1), (n_cb, 0) where it is empty."""
    lo = np.full(pattern.n_rb, pattern.n_cb, dtype=np.int64)
    hi = np.zeros(pattern.n_rb, dtype=np.int64)
    live = np.diff(pattern.ptr) > 0
    lo[live] = pattern.cb[pattern.ptr[:-1][live]]
    hi[live] = pattern.cb[pattern.ptr[1:][live] - 1] + 1
    return lo, hi


class _GroupBlocks:
    """The pattern's edges summed over groups of ``rps`` row blocks: the
    sorted keys group * n_cb + column block and their counts' prefix sums,
    from which :meth:`best_windows` reads ``band_spmm.best_windows`` of the
    window histogram without that (groups x column blocks) array."""

    def __init__(self, pattern: BlockPattern, rps: int):
        self.n_cb = pattern.n_cb
        self.n_g = -(-pattern.n_rb // rps)
        self.rps = rps
        key = (pattern.rb() // rps) * self.n_cb + pattern.cb
        cnt = pattern.cnt
        if rps > 1 and key.size:
            order = np.argsort(key, kind="stable")
            key, cnt = key[order], cnt[order]
            first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
            key, cnt = key[first], np.add.reduceat(cnt, first)
        self.key = key
        self.csum = np.concatenate(([0], np.cumsum(cnt)))

    def best_windows(self, wb: int) -> tuple:
        """(clo, covered) as ``band_spmm.best_windows`` gives them: each
        group's ``wb``-wide window start covering the most edges, the first
        such start; the edges all of them cover. The first best start is 0
        or a start where a nonzero block enters the window, so only those
        are scored."""
        n_cb, n_g = self.n_cb, self.n_g
        w = min(wb, n_cb)
        g, b = self.key // n_cb, self.key % n_cb
        s_b = b - w + 1
        ok = (s_b >= 0) & (s_b <= n_cb - w)
        cg = np.concatenate((np.arange(n_g, dtype=np.int64), g[ok]))
        cs = np.concatenate((np.zeros(n_g, dtype=np.int64), s_b[ok]))
        base = cg * n_cb + cs
        f = (self.csum[np.searchsorted(self.key, base + w)]
             - self.csum[np.searchsorted(self.key, base)])
        order = np.lexsort((cs, -f, cg))
        best = order[np.searchsorted(cg[order], np.arange(n_g))]
        return cs[best].astype(np.int32), int(f[best].sum())

    def outside(self, pattern: BlockPattern, wb: int,
                clo: np.ndarray) -> BlockPattern:
        """The pattern's blocks outside their group's ``wb``-wide window at
        ``clo``: the hybrid split's residue."""
        w = min(wb, self.n_cb)
        lo = clo[pattern.rb() // self.rps]
        return pattern.select((pattern.cb < lo) | (pattern.cb >= lo + w))


def _plan_block_sparse(row, col, w, n_node: int, dense_dtype: str,
                       band_rps: Optional[int], sparse_layout: str,
                       pat_sym: bool, with_costs: bool = False,
                       pattern: Optional[BlockPattern] = None):
    """The block-sparse layout for the "pallas" SpMM mode, as
    ``glass_tpu/ops/graph.py::_plan_block_sparse`` chooses it: returns
    ``(kind, rps, w_blocks)`` (and with ``with_costs`` the modeled seconds
    of each scored family as a 4th element), kind one of "bcsr", "band"
    (one uniform window) and "hybrid" (banded slabs over per-group windows
    of ``w_blocks`` plus BCSR over the out-of-window residue; needs a
    pattern-symmetric adjacency).

    Each candidate is scored ``n_steps * step_cost + streamed_bytes /
    stream_bps`` and the cheapest wins; a hybrid must beat the best single
    layout by ``_HYBRID_MARGIN``. Byte counts price bf16 and int8 at 2
    bytes, as the reference's time model does on purpose.

    Two differences from the reference: the stream rate carries the card's
    fill (:func:`_filled`; the same factor for every candidate of one
    graph); and a forced "band" with no window that passes ``band_vmem_ok``
    returns "bcsr" here, where the reference returns "band" at rps 8 past
    the layout rule (ROADMAP Queue 3).

    Every candidate is priced from the edges' :class:`BlockPattern`
    (``pattern``, or one pass over the edges): the same counts, spans and
    windows as the reference's passes over the edges and its dense
    histograms give, without them."""

    def _ret(kind, rps, wb, costs=None):
        if with_costs:
            return kind, rps, wb, (costs or {})
        return kind, rps, wb

    if sparse_layout == "bcsr":
        return _ret("bcsr", None, None)
    if band_rps is not None and sparse_layout != "hybrid":
        return _ret("band", int(band_rps), None)
    n_rb = -(-n_node // BLOCK)
    if pattern is None:
        pattern = block_pattern(row, col, w, n_rb, n_rb)
    itemsize = 4 if dense_dtype == "f32" else 2
    if pattern.n_blocks == 0:
        return _ret("bcsr", None, None)
    band_step_s, _, stream_bps = _cost_constants()
    stream_bps = _filled(stream_bps, n_node)

    bcsr_cost = _bcsr_cost_model(None, None, n_node, itemsize,
                                 pattern=pattern)
    best = ("bcsr", None, None)
    best_cost = bcsr_cost

    rb_span = _pattern_spans(pattern)
    band_candidates = []  # (cost, rps, full_w)
    for rps in (1, 2, 4, 8, 16):
        wb, _, nbytes, n_g = bd.band_stats(None, None, None, n_node, rps,
                                           rb_span=rb_span)
        if not bd.band_vmem_ok(rps, wb, H_PAD, itemsize):
            continue
        cost = n_g * band_step_s + nbytes * (itemsize / 4) / stream_bps
        band_candidates.append((cost, rps, wb))
        if cost < best_cost:
            best, best_cost = ("band", rps, None), cost
    if sparse_layout == "band":
        if band_candidates:
            return _ret("band", min(band_candidates)[1], None)
        return _ret("bcsr", None, None)

    hybrid_best = None  # (cost, rps, w)
    if pat_sym:
        n_cb = n_rb
        n_keep = pattern.n_edges
        for rps in (1, 2, 4, 8):
            n_g = -(-n_cb // rps)
            first = np.arange(0, n_rb, rps)
            lo = np.minimum.reduceat(rb_span[0], first)
            hi = np.maximum.reduceat(rb_span[1], first)
            widths = np.maximum(hi - lo, 1)[hi > 0]  # nonempty groups only
            if widths.size == 0:
                continue
            full_w = int(widths.max())
            # per-group span quantiles and small fixed windows
            cands = sorted({int(np.quantile(widths, q))
                            for q in (0.5, 0.75, 0.9)} | {2, 4, 8, 16})
            cands = [wb for wb in cands if 1 <= wb < full_w
                     and bd.band_vmem_ok(rps, wb, H_PAD, itemsize)]
            if not cands:
                continue
            # each width scored from the histogram, the residue's BCSR cost
            # approximated by the out-of-window share of the whole graph's
            groups = _GroupBlocks(pattern, rps)
            for wb in cands:
                _, covered = groups.best_windows(wb)
                out_frac = 1.0 - covered / max(n_keep, 1)
                if out_frac > 0.5:
                    continue  # the band no longer carries the bulk
                cost = (n_g * band_step_s
                        + n_g * rps * BLOCK * wb * BLOCK
                        * itemsize / stream_bps
                        + out_frac * bcsr_cost)
                if hybrid_best is None or cost < hybrid_best[0]:
                    hybrid_best = (cost, rps, wb)
    if hybrid_best is not None:
        # exact rescoring of the winner: the residue's own BCSR cost
        _, rps_h, wb_h = hybrid_best
        groups = _GroupBlocks(pattern, rps_h)
        residue = groups.outside(pattern, wb_h, groups.best_windows(wb_h)[0])
        n_g_h = -(-n_rb // rps_h)
        exact = (n_g_h * band_step_s
                 + n_g_h * rps_h * BLOCK * wb_h * BLOCK * itemsize
                 / stream_bps
                 + _bcsr_cost_model(None, None, n_node, itemsize,
                                    pattern=residue))
        hybrid_best = (exact, rps_h, wb_h)
    costs = {"bcsr": bcsr_cost}
    if band_candidates:
        costs["band"] = min(band_candidates)[0]
    if hybrid_best is not None:
        costs["hybrid"] = hybrid_best[0]
    if sparse_layout == "hybrid":
        if hybrid_best is None:
            raise ValueError(
                "sparse_layout='hybrid' requires a pattern-symmetric "
                "adjacency with a feasible band window")
        return _ret("hybrid", hybrid_best[1], hybrid_best[2], costs)
    if hybrid_best is not None and hybrid_best[0] < _HYBRID_MARGIN * best_cost:
        return _ret("hybrid", hybrid_best[1], hybrid_best[2], costs)
    return _ret(best[0], best[1], best[2], costs)


def _stored_bytes(kind, rps, wb, r_np, c_np, w_np, n_node, dense_dtype,
                  pattern: Optional[BlockPattern] = None):
    """The stored bytes of one direction of the planned block-sparse layout,
    at its true itemsize (1 for int8): what the memory cap holds it to
    (``glass_tpu/ops/graph.py:331-369``), from the edges' block pattern
    (``pattern``, or one pass over the edges)."""
    itemsize = 1 if dense_dtype == "int8" else (4 if dense_dtype == "f32"
                                                else 2)
    if kind not in ("bcsr", "band", "hybrid"):
        return 0
    n_rb = -(-n_node // BLOCK)
    if pattern is None:
        pattern = block_pattern(r_np, c_np, w_np, n_rb, n_rb)
    if kind == "bcsr":
        return pattern.n_blocks * BLOCK * BLOCK * itemsize
    if kind == "band":
        _, _, nbytes, _ = bd.band_stats(None, None, None, n_node, rps,
                                        rb_span=_pattern_spans(pattern))
        return nbytes * (itemsize / 4)
    n_g = -(-n_rb // rps)
    band_bytes = n_g * rps * BLOCK * wb * BLOCK * itemsize
    groups = _GroupBlocks(pattern, rps)
    residue = groups.outside(pattern, wb, groups.best_windows(wb)[0])
    return band_bytes + residue.n_blocks * BLOCK * BLOCK * itemsize


def _dense_segment_costs(n_node: int, n_edge: int, dense_dtype: str) -> dict:
    """The modeled seconds of the dense and the segment candidates, past
    their memory cap or not (``glass_tpu/ops/graph.py:307-377``): the dense
    matmul at ``_MXU_FLOPS`` (plus its streamed bytes with
    ``_DENSE_BYTE_TERM``; without them, the int8 dense kernel at
    ``_DENSE_Q_FLOPS`` where its layout's rule holds), the segment SpMM at
    ``_GATHER_BPS``."""
    itemsize_d = 4 if dense_dtype == "f32" else 2
    dense_bytes = n_node * n_node * (1 if dense_dtype == "int8"
                                     else itemsize_d)
    rate = _MXU_FLOPS["f32" if dense_dtype == "f32" else "bf16"]
    if dense_dtype == "int8" and not _DENSE_BYTE_TERM \
            and dense_q_vmem_ok(n_node, n_node):
        rate = _DENSE_Q_FLOPS
    dense_cost = 2.0 * n_node * n_node * 128 / rate
    if _DENSE_BYTE_TERM:
        dense_cost = dense_bytes / _cost_constants()[2] + dense_cost
    return {"dense": dense_cost, "dense_bytes": dense_bytes,
            "segment": n_edge * 2 * (16 + 128 * 4) / _GATHER_BPS}


def _auto_kind(kind, rps, wb, costs, r_np, c_np, w_np, n_node, n_edge,
               dense_dtype, pattern: Optional[BlockPattern] = None) -> str:
    """The auto plan's last step (``glass_tpu/ops/graph.py:307-377``): the
    dense and segment paths scored against the chosen block-sparse layout.
    A near-dense block pattern goes to the dense path; a layout past the
    memory cap is out, and when the dense matrix is past its cap too, the
    segment path takes the graph."""
    sparse_best = min(costs.values()) if costs else float("inf")
    other = _dense_segment_costs(n_node, n_edge, dense_dtype)
    dense_cost, seg_cost = other["dense"], other["segment"]
    if _stored_bytes(kind, rps, wb, r_np, c_np, w_np, n_node,
                     dense_dtype, pattern) > _layout_bytes_cap():
        sparse_best = float("inf")
    if other["dense_bytes"] > _DENSE_MXU_BYTES_CAP:
        dense_cost = float("inf")
    if dense_cost < min(sparse_best, seg_cost):
        return "dense"
    if seg_cost < min(sparse_best, dense_cost):
        return "segment"
    return kind


def affine_gate(n_node: int, rps: int, span,
                itemsize: int = 4) -> Optional[tuple]:
    """The affine window law (``band_spmm.affine_fit``) when its window is at
    most max(w + 1, 1.5 w) for the per-group width w and passes
    ``band_vmem_ok`` at ``itemsize`` (4 for f32, 2 for bf16 and int8), else
    None (per-group windows). Counterpart of ``_maybe_affine`` in
    ``glass_tpu/ops/graph.py::build_graph``; ``span`` is
    ``band_spmm.rowblock_spans`` of the nonzero edges."""
    fit = bd.affine_fit(None, None, None, n_node, rps, rb_span=span)
    if fit is None:
        return None
    wb_pg, _, _, _ = bd.band_stats(None, None, None, n_node, rps, rb_span=span)
    if fit[2] <= max(wb_pg + 1, int(1.5 * wb_pg)) and \
            bd.band_vmem_ok(rps, fit[2], BLOCK, itemsize):
        return fit
    return None


def _block_dtype(dense_dtype: str) -> str:
    """The slab and block dtype of the block-sparse layouts for a
    ``dense_dtype`` (``glass_tpu/ops/graph.py:291-296, 424, 469``)."""
    return {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}[dense_dtype]


def _dense_layout(row, col, w, n_node, n_edge, dense_dtype, dev):
    """(dense, dense_q, dense_q_t) at ``dense_dtype``, as
    ``glass_tpu/ops/graph.py::build_graph``'s ``_dense_layout``: int8 builds
    the row-quantized layout where ``dense_q_vmem_ok`` (the reference's
    layout rule) holds and the bf16 dense matrix where it does not."""
    d = np.zeros((n_node, n_node), dtype=np.float32)
    # duplicate (row, col) pairs accumulate, matching sparse-COO semantics
    np.add.at(d, (row[:n_edge], col[:n_edge]), w[:n_edge])
    if dense_dtype == "int8" and dense_q_vmem_ok(n_node, n_node):
        dq = build_dense_q(d, device=dev)
        sym = coo_is_symmetric(row[:n_edge], col[:n_edge], w[:n_edge])
        return None, dq, (dq if sym else build_dense_q(d.T, device=dev))
    dense = torch.from_numpy(d)
    if dense_dtype != "f32":
        dense = dense.to(torch.bfloat16)
    return dense.to(dev), None, None


def _band_pair(r_, c_, w_, n_node, rps, rps_t, symmetric, dense_dtype, dev):
    """(band, band_t) at the planned rps of each direction, each with the
    affine law where ``affine_gate`` takes it."""
    itemsize = 4 if dense_dtype == "f32" else 2
    keep = w_ != 0

    def one(rr, cc, rps_):
        span = bd.rowblock_spans(rr[keep], cc[keep], n_node)
        return bd.build_band(rr, cc, w_, n_node, rps_,
                             affine=affine_gate(n_node, rps_, span, itemsize),
                             dtype=_block_dtype(dense_dtype), device=dev)

    band = one(r_, c_, rps)
    return band, (band if symmetric else one(c_, r_, rps_t))


def _hybrid_layouts(r_, c_, w_, n_node, rps, wb, symmetric, dense_dtype,
                    dev):
    """(band, band_t, bcsr, bcsr_t) of the hybrid split A = A_band +
    A_out (``glass_tpu/ops/graph.py:436-464``): each group's best ``wb``-wide
    window, the in-window mask symmetrized (an edge is in the band only if
    its mirror is too, so one window table serves A and A^T), the band over
    those windows and BCSR over the rest."""
    r_, c_ = r_.astype(np.int64), c_.astype(np.int64)
    clo, in_band = bd.plan_windows(r_, c_, w_, n_node, rps, wb)
    o1 = np.lexsort((c_, r_))
    o2 = np.lexsort((r_, c_))
    sym = in_band.copy()
    sym[o1] &= in_band[o2]  # (r, c) and its mirror at the same rank
    out = (w_ != 0) & ~sym
    dt = _block_dtype(dense_dtype)
    band = bd.build_band(r_[sym], c_[sym], w_[sym], n_node, rps, dtype=dt,
                         window=(wb, clo), device=dev)
    band_t = band if symmetric else bd.build_band(
        c_[sym], r_[sym], w_[sym], n_node, rps, dtype=dt, window=(wb, clo),
        device=dev)
    bcsr = build_bcsr(r_[out], c_[out], w_[out], n_node, dtype=dt, device=dev)
    bcsr_t = bcsr if symmetric else build_bcsr(c_[out], r_[out], w_[out],
                                               n_node, dtype=dt, device=dev)
    return band, band_t, bcsr, bcsr_t


def build_graph(
    edge_index: np.ndarray,
    edge_weight: Optional[np.ndarray],
    n_node: int,
    aggr: str = "sum",
    *,
    materialize_dense: Optional[bool] = None,
    dense_dtype: str = "f32",
    materialize_bcsr: bool = False,
    add_self_loops: bool = False,
    sparse_layout: str = "auto",
    band_rps: Optional[int] = None,
    device="cuda",
) -> Graph:
    """Builds a :class:`Graph` from a host-side COO edge list.

    Args:
      edge_index: (2, E) integer array; edge_index[0] = destination rows.
      edge_weight: (E,) weights or None for all-ones.
      n_node: number of nodes.
      aggr: normalization ("mean" | "sum" | "gcn").
      materialize_dense: force/forbid the dense adjacency; default: auto
        (n_node <= DENSE_NODE_LIMIT).
      dense_dtype: "f32" (exact), "bf16" (bf16 dense matrix, slabs and
        blocks) or "int8" (the row-quantized int8 dense layout, or the bf16
        matrix where the reference's layout rule refuses it; int8 slabs and
        blocks with per-row scales).
      materialize_bcsr: build a block-sparse layout for the "pallas" SpMM
        mode, as ``sparse_layout`` says.
      add_self_loops: append a weight-1 self-loop on every node before
        normalizing (PyG GCNConv's default, as the JAX builder's keyword).
      sparse_layout: "auto" (the planner scores band, BCSR, hybrid, the
        dense and the segment paths and builds its choice, recorded in
        ``Graph.plan``), "band" (banded slabs with the planner's rps,
        window and affine law; BCSR both ways when A or A^T has no feasible
        band), "bcsr" (chunked BCSR) or "hybrid" (band over per-group
        windows plus BCSR over the residue; needs a pattern-symmetric A).
      band_rps: rows-per-group of the band layout (None = planned).
      device: "cuda" (default; raises without a card) or "cpu".
    """
    if dense_dtype not in DENSE_DTYPES:
        raise ValueError(f"unknown dense_dtype {dense_dtype!r}: use one of "
                         f"{DENSE_DTYPES}")
    if materialize_bcsr and sparse_layout not in SPARSE_LAYOUTS:
        raise ValueError(f"unknown sparse_layout {sparse_layout!r}: use one "
                         f"of {SPARSE_LAYOUTS}")
    dev = resolve_device(device)
    edge_index = np.asarray(edge_index)
    if add_self_loops:
        loops = np.stack([np.arange(n_node)] * 2)
        edge_index = np.concatenate([edge_index, loops], axis=1)
        if edge_weight is not None:
            edge_weight = np.concatenate(
                [np.asarray(edge_weight), np.ones(n_node, dtype=np.float32)])
    n_edge = edge_index.shape[1]
    if n_edge and (edge_index.min() < 0 or edge_index.max() >= n_node):
        raise ValueError(f"edge endpoints must lie in [0, {n_node})")
    if aggr not in native.AGGR_CODES:
        raise NotImplementedError(f"unknown aggr {aggr!r}")
    # Sort by (row, col) and normalize, as the JAX builder does: in the
    # native library where it is built, else in numpy (the same arrays).
    # Pad with zero-weight self-referential edges on the last node: they are
    # sorted-order-preserving and contribute exactly 0 to every aggregation.
    e_pad = max(EDGE_BUCKET, -(-n_edge // EDGE_BUCKET) * EDGE_BUCKET)
    csr = native.build_csr(edge_index, edge_weight, n_node, aggr,
                           pad_to=e_pad)
    if csr is not None:
        # int32 on the host (row-sorted: the lean paths below take them),
        # widened to int64 on the device
        row, col, w = csr
        del csr
    else:
        if edge_weight is None:
            edge_weight = np.ones(n_edge, dtype=np.float32)
        w = normalized_edge_weight(edge_index, edge_weight, n_node, aggr)
        row = edge_index[0].astype(np.int64)
        col = edge_index[1].astype(np.int64)
        order = np.lexsort((col, row))
        row, col, w = row[order], col[order], w[order]
        pad = e_pad - n_edge
        if pad:
            row = np.concatenate([row, np.full(pad, n_node - 1,
                                               dtype=np.int64)])
            col = np.concatenate([col, np.full(pad, n_node - 1,
                                               dtype=np.int64)])
            w = np.concatenate([w, np.zeros(pad, dtype=np.float32)])
    del edge_index, edge_weight  # the caller's, if it kept them

    if materialize_dense is None:
        materialize_dense = n_node <= DENSE_NODE_LIMIT
    dense = dense_q = dense_q_t = None
    if materialize_dense:
        dense, dense_q, dense_q_t = _dense_layout(row, col, w, n_node, n_edge,
                                                  dense_dtype, dev)

    bcsr = bcsr_t = band = band_t = None
    plan = None
    if materialize_bcsr:
        r_, c_, w_ = row[:n_edge], col[:n_edge], w[:n_edge]
        symmetric = coo_is_symmetric(r_, c_, w_)
        pat_sym = symmetric or coo_is_symmetric(
            r_, c_, (w_ != 0).astype(np.float32))
        n_rb = -(-n_node // BLOCK)
        pattern = block_pattern(r_, c_, w_, n_rb, n_rb)
        kind, rps, wb, costs = _plan_block_sparse(
            r_, c_, w_, n_node, dense_dtype, band_rps, sparse_layout,
            pat_sym, with_costs=True, pattern=pattern)
        if sparse_layout == "auto" and band_rps is None:
            kind = _auto_kind(kind, rps, wb, costs, r_, c_, w_, n_node,
                              n_edge, dense_dtype, pattern)
        del pattern
        if kind == "dense" and not materialize_dense:
            dense, dense_q, dense_q_t = _dense_layout(
                row, col, w, n_node, n_edge, dense_dtype, dev)
        rps_t = rps
        if kind == "band" and not symmetric:
            # the backward needs a band of A^T too, planned on its own; BCSR
            # both ways when it has none
            kind_t, rps_t, _ = _plan_block_sparse(
                c_, r_, w_, n_node, dense_dtype, band_rps,
                "auto" if sparse_layout == "auto" else "band", pat_sym)
            if kind_t != "band":
                kind = "bcsr"
        if kind == "band":
            band, band_t = _band_pair(r_, c_, w_, n_node, rps, rps_t,
                                      symmetric, dense_dtype, dev)
        elif kind == "hybrid":
            band, band_t, bcsr, bcsr_t = _hybrid_layouts(
                r_, c_, w_, n_node, rps, wb, symmetric, dense_dtype, dev)
        elif kind == "bcsr":
            bdt = _block_dtype(dense_dtype)
            bcsr = build_bcsr(r_, c_, w_, n_node, dtype=bdt, device=dev)
            bcsr_t = bcsr if symmetric else build_bcsr(
                c_, r_, w_, n_node, dtype=bdt, device=dev)
        # "dense" and "segment": no block-sparse layout; spmm's "pallas"
        # mode follows the plan
        if sparse_layout == "auto":
            plan = kind

    return Graph(
        row=torch.from_numpy(row).to(dev).long(),
        col=torch.from_numpy(col).to(dev).long(),
        weight=torch.from_numpy(w).to(dev),
        dense=dense,
        n_node=int(n_node),
        n_edge=int(n_edge),
        aggr=aggr,
        bcsr=bcsr,
        bcsr_t=bcsr_t,
        band=band,
        band_t=band_t,
        dense_q=dense_q,
        dense_q_t=dense_q_t,
        plan=plan,
    )


def degrees(edge_index: np.ndarray, edge_weight: Optional[np.ndarray],
            n_node: int) -> np.ndarray:
    """Weighted row-degree vector, host-side (reference: datasets.py:45-52)."""
    row = np.asarray(edge_index[0])
    if edge_weight is None:
        edge_weight = np.ones(row.shape[0], dtype=np.float64)
    return np.bincount(row, weights=np.asarray(edge_weight, dtype=np.float64),
                       minlength=n_node)

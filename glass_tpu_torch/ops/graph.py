"""Graph container and normalized-adjacency construction.

Counterpart of ``glass_tpu/ops/graph.py``. The normalization is computed on
the host in numpy, exactly as the JAX package does it:

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
layout (``ops/bcsr_spmm.py``) and the banded slabs (``ops/band_spmm.py``)
with the JAX builder's forced-band plan, at the JAX builder's dtypes for
each ``dense_dtype``; the "auto" planner and hybrid splits are still to be
ported and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from glass_tpu_torch.ops import band_spmm as bd
from glass_tpu_torch.ops._common import BLOCK, resolve_device
from glass_tpu_torch.ops.bcsr_spmm import BCSR, build_bcsr, coo_is_symmetric
from glass_tpu_torch.ops.dense_q import DenseQ, build_dense_q, dense_q_vmem_ok

# Edge padding bucket (the JAX package pads to keep compiled shapes few; the
# port pads the same way so that its edge arrays equal the JAX builder's).
EDGE_BUCKET = 1024

# Default max node count for which the dense adjacency is materialized
# (n^2 float32 <= 256 MiB at 8192).
DENSE_NODE_LIMIT = 8192

# The reference planner's ranking constants for band layouts (fitted on TPU
# v5e: a per-group step cost and a slab stream rate). They only rank the rps
# candidates, so that the port picks the JAX builder's rps; they are not
# times of this port. Their refit on the H100 is ROADMAP Queue 1 item 6.
_BAND_STEP_COST_S = 1.5e-6
_BAND_STREAM_BPS = 150e9
RPS_CANDIDATES = (1, 2, 4, 8, 16)
DENSE_DTYPES = ("f32", "bf16", "int8")


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
      bcsr:   optional chunked-BCSR layout of A for the "pallas" SpMM mode.
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

    @property
    def device(self) -> torch.device:
        return self.row.device


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


def _check_layout_request(materialize_bcsr, sparse_layout, dense_dtype):
    if dense_dtype not in DENSE_DTYPES:
        raise ValueError(f"unknown dense_dtype {dense_dtype!r}: use one of "
                         f"{DENSE_DTYPES}")
    if not materialize_bcsr:
        return
    if sparse_layout in ("auto", "hybrid"):
        raise NotImplementedError(
            f"sparse_layout={sparse_layout!r}: the layout planner and the "
            "hybrid split are ROADMAP Queue 1 item 6; pass sparse_layout="
            "'band' or 'bcsr' (on the command line: --sparse_layout "
            "band|bcsr)")
    if sparse_layout not in ("band", "bcsr"):
        raise ValueError(f"unknown sparse_layout {sparse_layout!r}")


def plan_band_rps(row, col, w, n_node: int,
                  band_rps: Optional[int] = None,
                  itemsize: int = 4) -> Optional[int]:
    """rps of a banded layout of A (rows ``row``, columns ``col``), as the
    JAX builder's forced-band plan picks it (the ``sparse_layout="band"``
    branch of ``glass_tpu/ops/graph.py::_plan_block_sparse``): ``band_rps``
    when given; else, of the candidates whose window passes
    ``band_vmem_ok``, the one of least ranking cost (ties to the smaller
    rps). ``itemsize`` is the reference's slab itemsize for the plan: 4 for
    f32, 2 for bf16 and int8 (it prices int8 streams at bf16 bytes on
    purpose, ``graph.py:639-650``). None when A has no nonzero edge or no
    candidate passes: where the JAX forced plan then takes rps 8 past the
    gate, the port falls back to BCSR (``build_graph``)."""
    if band_rps is not None:
        return int(band_rps)
    keep = np.asarray(w) != 0
    r_, c_ = np.asarray(row)[keep], np.asarray(col)[keep]
    if r_.size == 0:
        return None
    span = bd.rowblock_spans(r_, c_, n_node)
    cands = []
    for rps in RPS_CANDIDATES:
        wb, _, nbytes, n_g = bd.band_stats(None, None, None, n_node, rps,
                                           rb_span=span)
        if bd.band_vmem_ok(rps, wb, BLOCK, itemsize):
            cost = nbytes * (itemsize / 4) / _BAND_STREAM_BPS
            cands.append((n_g * _BAND_STEP_COST_S + cost, rps))
    return min(cands)[1] if cands else None


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


def _build_band_pair(r_, c_, w_, n_node, symmetric, band_rps, dense_dtype,
                     dev):
    """(band, band_t), or None when A or A^T has no feasible band. The
    transpose is planned on its own; on None the caller falls back to BCSR
    both ways (``glass_tpu/ops/graph.py:380-392``)."""
    itemsize = 4 if dense_dtype == "f32" else 2
    rps = plan_band_rps(r_, c_, w_, n_node, band_rps, itemsize)
    rps_t = rps if symmetric else plan_band_rps(c_, r_, w_, n_node, band_rps,
                                                itemsize)
    if rps is None or rps_t is None:
        return None
    keep = w_ != 0

    def one(rr, cc, rps_):
        span = bd.rowblock_spans(rr[keep], cc[keep], n_node)
        return bd.build_band(rr, cc, w_, n_node, rps_,
                             affine=affine_gate(n_node, rps_, span, itemsize),
                             dtype=_block_dtype(dense_dtype), device=dev)

    band = one(r_, c_, rps)
    return band, (band if symmetric else one(c_, r_, rps_t))


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


def build_graph(
    edge_index: np.ndarray,
    edge_weight: Optional[np.ndarray],
    n_node: int,
    aggr: str = "sum",
    *,
    materialize_dense: Optional[bool] = None,
    dense_dtype: str = "f32",
    materialize_bcsr: bool = False,
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
      sparse_layout: "band" (banded slabs with the JAX builder's rps,
        window and affine law; BCSR both ways when A or A^T has no feasible
        band) or "bcsr" (chunked BCSR).
      band_rps: rows-per-group of the band layout (None = planned).
      device: "cuda" (default; raises without a card) or "cpu".
    """
    _check_layout_request(materialize_bcsr, sparse_layout, dense_dtype)
    dev = resolve_device(device)
    edge_index = np.asarray(edge_index)
    n_edge = edge_index.shape[1]
    if n_edge and (edge_index.min() < 0 or edge_index.max() >= n_node):
        raise ValueError(f"edge endpoints must lie in [0, {n_node})")
    if edge_weight is None:
        edge_weight = np.ones(n_edge, dtype=np.float32)
    w = normalized_edge_weight(edge_index, edge_weight, n_node, aggr)
    # Sort by (row, col), as the JAX builder does.
    row, col = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    order = np.lexsort((col, row))
    row, col, w = row[order], col[order], w[order]

    # Pad with zero-weight self-referential edges on the last node: they are
    # sorted-order-preserving and contribute exactly 0 to every aggregation.
    e_pad = max(EDGE_BUCKET, -(-n_edge // EDGE_BUCKET) * EDGE_BUCKET)
    pad = e_pad - n_edge
    if pad:
        row = np.concatenate([row, np.full(pad, n_node - 1, dtype=np.int64)])
        col = np.concatenate([col, np.full(pad, n_node - 1, dtype=np.int64)])
        w = np.concatenate([w, np.zeros(pad, dtype=np.float32)])

    if materialize_dense is None:
        materialize_dense = n_node <= DENSE_NODE_LIMIT
    dense = dense_q = dense_q_t = None
    if materialize_dense:
        dense, dense_q, dense_q_t = _dense_layout(row, col, w, n_node, n_edge,
                                                  dense_dtype, dev)

    bcsr = bcsr_t = band = band_t = None
    if materialize_bcsr:
        r_, c_, w_ = row[:n_edge], col[:n_edge], w[:n_edge]
        symmetric = coo_is_symmetric(r_, c_, w_)
        pair = None
        if sparse_layout == "band":
            pair = _build_band_pair(r_, c_, w_, n_node, symmetric, band_rps,
                                    dense_dtype, dev)
        if pair is not None:
            band, band_t = pair
        else:
            bdt = _block_dtype(dense_dtype)
            bcsr = build_bcsr(r_, c_, w_, n_node, dtype=bdt, device=dev)
            bcsr_t = bcsr if symmetric else build_bcsr(
                c_, r_, w_, n_node, dtype=bdt, device=dev)

    return Graph(
        row=torch.from_numpy(row).to(dev),
        col=torch.from_numpy(col).to(dev),
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
    )


def degrees(edge_index: np.ndarray, edge_weight: Optional[np.ndarray],
            n_node: int) -> np.ndarray:
    """Weighted row-degree vector, host-side (reference: datasets.py:45-52)."""
    row = np.asarray(edge_index[0])
    if edge_weight is None:
        edge_weight = np.ones(row.shape[0], dtype=np.float64)
    return np.bincount(row, weights=np.asarray(edge_weight, dtype=np.float64),
                       minlength=n_node)

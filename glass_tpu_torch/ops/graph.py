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

Of the adjacency layouts, this port builds the dense f32 matrix and the
chunked BCSR layout (``ops/bcsr_spmm.py``); the planner, banded slabs,
hybrid splits and bf16/int8 adjacencies are still to be ported and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from glass_tpu_torch.ops._common import resolve_device
from glass_tpu_torch.ops.bcsr_spmm import BCSR, build_bcsr, coo_is_symmetric

# Edge padding bucket (the JAX package pads to keep compiled shapes few; the
# port pads the same way so that its edge arrays equal the JAX builder's).
EDGE_BUCKET = 1024

# Default max node count for which the dense adjacency is materialized
# (n^2 float32 <= 256 MiB at 8192).
DENSE_NODE_LIMIT = 8192


@dataclass(frozen=True)
class Graph:
    """A normalized graph on one device.

    Attributes:
      row:    (E_pad,) int64, destination node of each directed edge,
              ascending.
      col:    (E_pad,) int64, source node of each directed edge.
      weight: (E_pad,) float32 normalized edge weight; 0.0 on padding edges.
      dense:  optional (n_node, n_node) float32 dense normalized adjacency.
      n_node: node count.
      n_edge: real (unpadded) directed edge count.
      aggr:   which normalization was applied ("mean" | "sum" | "gcn").
      bcsr:   optional chunked-BCSR layout of A for the "pallas" SpMM mode.
      bcsr_t: the layout of A^T (the same object when A is symmetric), for
              the backward pass of a later training slice.
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


def _check_layout_request(materialize_bcsr, sparse_layout, dense_dtype,
                          band_rps):
    if dense_dtype != "f32":
        raise NotImplementedError(
            f"dense_dtype={dense_dtype!r}: only 'f32' is ported; bf16 and "
            "int8 adjacencies are ROADMAP Queue 1 item 7")
    if band_rps is not None:
        raise NotImplementedError(
            "band_rps: banded-slab layouts are ROADMAP Queue 1 item 6 and "
            "Queue 2 B-C")
    if not materialize_bcsr:
        return
    if sparse_layout == "auto":
        raise NotImplementedError(
            "sparse_layout='auto': the layout planner is ROADMAP Queue 1 "
            "item 6; pass sparse_layout='bcsr'")
    if sparse_layout in ("band", "hybrid"):
        raise NotImplementedError(
            f"sparse_layout={sparse_layout!r}: banded-slab layouts are "
            "ROADMAP Queue 1 item 6 and Queue 2 B-C")
    if sparse_layout != "bcsr":
        raise ValueError(f"unknown sparse_layout {sparse_layout!r}")


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
      materialize_dense: force/forbid the dense f32 adjacency; default: auto
        (n_node <= DENSE_NODE_LIMIT).
      dense_dtype: "f32" (the only ported adjacency dtype).
      materialize_bcsr: build the chunked-BCSR layout for the "pallas" SpMM
        mode; needs sparse_layout="bcsr".
      sparse_layout: "bcsr" (the only ported block-sparse layout).
      band_rps: not ported; must be None.
      device: "cuda" (default; raises without a card) or "cpu".
    """
    _check_layout_request(materialize_bcsr, sparse_layout, dense_dtype,
                          band_rps)
    dev = resolve_device(device)
    edge_index = np.asarray(edge_index)
    n_edge = edge_index.shape[1]
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
    dense = None
    if materialize_dense:
        d = np.zeros((n_node, n_node), dtype=np.float32)
        # duplicate (row, col) pairs accumulate, matching sparse-COO semantics
        np.add.at(d, (row[:n_edge], col[:n_edge]), w[:n_edge])
        dense = torch.from_numpy(d).to(dev)

    bcsr = bcsr_t = None
    if materialize_bcsr:
        r_, c_, w_ = row[:n_edge], col[:n_edge], w[:n_edge]
        bcsr = build_bcsr(r_, c_, w_, n_node, device=dev)
        bcsr_t = bcsr if coo_is_symmetric(r_, c_, w_) else build_bcsr(
            c_, r_, w_, n_node, device=dev)

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
    )


def degrees(edge_index: np.ndarray, edge_weight: Optional[np.ndarray],
            n_node: int) -> np.ndarray:
    """Weighted row-degree vector, host-side (reference: datasets.py:45-52)."""
    row = np.asarray(edge_index[0])
    if edge_weight is None:
        edge_weight = np.ones(row.shape[0], dtype=np.float64)
    return np.bincount(row, weights=np.asarray(edge_weight, dtype=np.float64),
                       minlength=n_node)

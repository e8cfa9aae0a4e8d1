"""SDDMM, sampled dense-dense matrix multiplication, and the segment
softmax of attention (counterpart of ``glass_tpu/ops/sddmm.py``).

``out[e] = <x[row[e]], y[col[e]]>`` for each edge of a :class:`Graph`, by
one of two strategies:

- ``gather``: two row gathers and a sum over features;
- ``dense``: ``X @ Y^T`` in f32 (TF32 off), then the edges' entries,
  while the N^2 scores fit (N <= 4,096 by default).

``segment_softmax`` normalizes edge scores over each destination row.
Neither function reaches a TPU kernel in the JAX package; both are plain
PyTorch here, differentiable by autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from glass_tpu_torch.ops.graph import Graph

DENSE_NODE_LIMIT = 4096  # the automatic mode's largest dense N


def sddmm_gather(graph: Graph, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(E_pad,) edge scores by row gathers."""
    return (x.index_select(0, graph.row) * y.index_select(0, graph.col)).sum(-1)


def sddmm_dense(graph: Graph, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(E_pad,) edge scores from the full f32 ``X @ Y^T``."""
    scores = torch.matmul(x.float(), y.float().t())
    return scores[graph.row, graph.col]


def sddmm(graph: Graph, x: torch.Tensor, y: Optional[torch.Tensor] = None,
          mode: Optional[str] = None) -> torch.Tensor:
    """Edge scores for the graph's (padded) edge list; padding edges get a
    score too (mask with ``graph.weight != 0`` where that matters).

    Args:
      graph: the graph (``row`` and ``col`` name the sampled pairs).
      x: (N, F) destination-side features.
      y: (N, F) source-side features (default: x).
      mode: "dense" | "gather" | None (dense up to DENSE_NODE_LIMIT nodes).
    """
    if y is None:
        y = x
    if mode is None:
        mode = "dense" if graph.n_node <= DENSE_NODE_LIMIT else "gather"
    if mode == "dense":
        return sddmm_dense(graph, x, y)
    if mode == "gather":
        return sddmm_gather(graph, x, y)
    raise ValueError(f"unknown sddmm mode {mode!r}")


def segment_softmax(graph: Graph, scores: torch.Tensor) -> torch.Tensor:
    """Softmax of edge scores over each destination row (attention
    weights), shifted by the row's max. Padding edges (weight 0) are left
    out and get weight 0; the denominator is clamped at 1e-16."""
    valid = graph.weight != 0
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(valid, scores, neg)
    row_max = scores.new_full((graph.n_node,), neg).scatter_reduce(
        0, graph.row, masked, reduce="amax", include_self=False)
    ex = torch.where(valid, torch.exp(masked - row_max[graph.row]), 0.0)
    denom = scores.new_zeros(graph.n_node).index_add_(0, graph.row, ex)
    return ex / denom[graph.row].clamp(min=1e-16)

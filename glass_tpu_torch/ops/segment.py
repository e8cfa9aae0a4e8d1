"""Subgraph pooling as a dense masked gather-reduce (counterpart of
``glass_tpu/ops/segment.py``).

The padded (B, L) node matrix is gathered into (B, L, F) and reduced over L
under the mask. Rows that are entirely -1 (padding of a request batch) pool
to 0.

Pool semantics (parity with reference impl/models.py:295-319):
  sum  : sum_i x_i
  mean : sum_i x_i / |S|
  max  : max_i x_i
  size : sum_i x_i / sqrt(|S|)   (GraphSizeNorm then add-pool)
"""

from __future__ import annotations

import torch

POOL_KINDS = ("sum", "mean", "max", "size")


def pool_subgraphs(emb: torch.Tensor, pos: torch.Tensor, kind: str) -> torch.Tensor:
    """Pools node embeddings over padded subgraph node sets.

    Args:
      emb: (N, F) node embeddings.
      pos: (B, L) int tensor of node indices, padded with -1.
      kind: one of POOL_KINDS.

    Returns:
      (B, F) subgraph embeddings.
    """
    mask = pos >= 0  # (B, L)
    safe = torch.where(mask, pos, 0).long()
    g = emb[safe]  # (B, L, F) dense gather
    m = mask[..., None].to(emb.dtype)
    if kind == "sum":
        return (g * m).sum(dim=1)
    if kind == "mean":
        cnt = m.sum(dim=1)
        return (g * m).sum(dim=1) / torch.clamp(cnt, min=1.0)
    if kind == "max":
        neg = torch.where(mask[..., None], g, float("-inf"))
        out = neg.amax(dim=1)
        # all-padding rows -> 0 instead of -inf
        any_valid = mask.any(dim=1, keepdim=True)
        return torch.where(any_valid, out, 0.0)
    if kind == "size":
        cnt = m.sum(dim=1)
        return (g * m).sum(dim=1) / torch.sqrt(torch.clamp(cnt, min=1.0))
    raise ValueError(f"unknown pool kind {kind!r}")


def mean_over_nodes(emb: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The plain mean of ``emb`` over a fixed-width (unpadded) (B, L) node
    index matrix: the link-prediction head's mean of the two endpoints'
    embeddings (reference: impl/models.py:501-504)."""
    return emb[pos].mean(dim=1)

"""Subgraph pooling as a dense masked gather-reduce (counterpart of
``glass_tpu/ops/segment.py``).

The padded (B, L) node matrix is gathered into (B, L, F) and reduced over L
under the mask. Rows that are entirely -1 (padding of a request batch) pool
to 0. A padding slot gathers a row of its own (:func:`gather_index`), which
the mask zeroes, so the gather's backward sums no long run of one index.

Pool semantics (parity with reference impl/models.py:295-319):
  sum  : sum_i x_i
  mean : sum_i x_i / |S|
  max  : max_i x_i
  size : sum_i x_i / sqrt(|S|)   (GraphSizeNorm then add-pool)
"""

from __future__ import annotations

import torch

POOL_KINDS = ("sum", "mean", "max", "size")


def gather_index(pos: torch.Tensor, n: int) -> torch.Tensor:
    """The (B, L) int64 rows that the pool gathers: ``pos`` where a slot
    holds a node, and slot ``k`` of the flattened matrix row ``k mod n``
    where it is padding (-1).

    The gather's backward on the card sorts the indices and sums each
    index's slots one after another, so padding sent to one row would be
    one serial run of thousands of slots; spread over the rows, no index
    holds more than ceil(B L / n) of them. A padding slot's gradient is an
    exact zero (the mask), and the sort is stable, so wherever the slots of
    an index are summed in order the sums are bit-equal to those of any
    other choice of padding rows. Its value is masked too, as long as the
    row it gathers is finite.
    """
    spare = torch.arange(pos.numel(), device=pos.device).view(pos.shape) % n
    return torch.where(pos >= 0, pos.long(), spare)


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
    g = emb[gather_index(pos, emb.shape[0])]  # (B, L, F) dense gather
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

"""GraphNorm with whole-graph statistics (counterpart of
``glass_tpu/ops/norm.py``, its sharded path included), and
``graph_size_norm``.

PyG 1.7.2's formula, which the reference uses with ``batch=None``:

    mean = mean_n(x)                       # per feature
    out  = x - mean * mean_scale           # learnable mean scale (alpha)
    var  = mean_n(out^2)                   # NOT re-centered
    y    = weight * out / sqrt(var + eps) + bias,   eps = 1e-5

A bf16 x (mixed precision) is read and written in bf16, with the
statistics and the normalization in f32 (``norm.py:43-52``).
"""

from __future__ import annotations

from typing import Optional

import torch

from glass_tpu_torch.ops.collectives import sum_over


def graph_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    mean_scale: torch.Tensor,
    eps: float = 1e-5,
    *,
    axis=None,
    node_mask: Optional[torch.Tensor] = None,
    n_total: Optional[int] = None,
) -> torch.Tensor:
    """Whole-graph GraphNorm of (N, F) f32 or bf16 activations; the result
    has x's dtype.

    Sharded (``axis``, the graph axis's process group, with x one node
    block): the f32 column sums are all-reduced over ``axis``
    (differentiably, ``ops/collectives.py``), ``node_mask`` keeps the
    block's padding rows out of them, and ``n_total`` is the global real
    node count (``glass_tpu/ops/norm.py:28-83``)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"graph_norm takes float32 or bfloat16, not {x.dtype}")
    xf = x.float()
    if axis is None:
        mean = xf.mean(dim=0)
        out = xf - mean * mean_scale
        var = (out * out).mean(dim=0)
        return (weight * out / torch.sqrt(var + eps) + bias).to(x.dtype)
    if n_total is None:
        raise ValueError("a sharded graph_norm needs n_total")

    def masked(t):
        return t if node_mask is None else torch.where(node_mask[:, None],
                                                       t, 0.0)

    mean = sum_over(masked(xf).sum(dim=0), axis) / n_total
    out = xf - mean * mean_scale
    om = masked(out)
    var = sum_over((om * om).sum(dim=0), axis) / n_total
    return (weight * out / torch.sqrt(var + eps) + bias).to(x.dtype)


def graph_size_norm(x: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """x_i / sqrt(|G_i|) given per-row subgraph sizes (PyG GraphSizeNorm;
    reference impl/models.py:310-319). The size pool of
    ``ops/segment.py::pool_subgraphs`` has it built in; this is the
    standalone form."""
    return x / torch.sqrt(counts.clamp(min=1.0))[:, None]

"""GraphNorm with whole-graph statistics (counterpart of the unsharded path
of ``glass_tpu/ops/norm.py``).

PyG 1.7.2's formula, which the reference uses with ``batch=None``:

    mean = mean_n(x)                       # per feature
    out  = x - mean * mean_scale           # learnable mean scale (alpha)
    var  = mean_n(out^2)                   # NOT re-centered
    y    = weight * out / sqrt(var + eps) + bias,   eps = 1e-5

A bf16 x (mixed precision) is read and written in bf16, with the
statistics and the normalization in f32 (``norm.py:43-52``).
"""

from __future__ import annotations

import torch


def graph_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    mean_scale: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Whole-graph GraphNorm of (N, F) f32 or bf16 activations; the result
    has x's dtype."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"graph_norm takes float32 or bfloat16, not {x.dtype}")
    xf = x.float()
    mean = xf.mean(dim=0)
    out = xf - mean * mean_scale
    var = (out * out).mean(dim=0)
    return (weight * out / torch.sqrt(var + eps) + bias).to(x.dtype)

"""GraphNorm with whole-graph statistics (counterpart of the unsharded f32
path of ``glass_tpu/ops/norm.py``).

PyG 1.7.2's formula, which the reference uses with ``batch=None``:

    mean = mean_n(x)                       # per feature
    out  = x - mean * mean_scale           # learnable mean scale (alpha)
    var  = mean_n(out^2)                   # NOT re-centered
    y    = weight * out / sqrt(var + eps) + bias,   eps = 1e-5
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
    """Whole-graph GraphNorm of (N, F) f32 activations."""
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"graph_norm of {x.dtype}: only float32 is ported (mixed "
            "precision is ROADMAP Queue 1 item 7)")
    mean = x.mean(dim=0)
    out = x - mean * mean_scale
    var = (out * out).mean(dim=0)
    return weight * out / torch.sqrt(var + eps) + bias

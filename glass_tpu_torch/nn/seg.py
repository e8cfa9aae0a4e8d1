"""GNN-seg baseline models as ``torch.nn`` modules (counterpart of
``glass_tpu/nn/seg.py``; reference GNNSeg.py:70-171).

Message passing is batched and dense: per-subgraph adjacencies (B, L, L)
times features (B, L, F), one ``torch.bmm`` a layer, in f32 with TF32 off
(``resolve_device`` turns it off for the port, the counterpart of the JAX
modules' ``Precision.HIGHEST``). GraphNorm statistics span every *valid*
node of the batch: the reference calls PyG GraphNorm with batch=None on
the merged graph, which couples the subgraphs of one batch
(GNNSeg.py:117-118). Padded rows are written like valid ones (the norm's
affine map, the GCN bias) and only the sum pool masks them, as in JAX.

Submodule and parameter names are the flax names (``conv_i``, ``gn_i``,
``pred``; a GCN kernel is the transposed ``weight``), so
``utils/checkpoint.py::params_from_flax`` loads JAX's parameters.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from glass_tpu_torch.nn.dropout import Dropout
from glass_tpu_torch.nn.modules import ACTIVATIONS, MLP, TorchLinear
from glass_tpu_torch.ops._common import resolve_device


class MaskedGraphNorm(nn.Module):
    """GraphNorm over every valid node of the batch (the merged graph's
    batch=None statistics); ``mask`` (B, L) marks the valid nodes."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean_scale = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None].to(x.dtype)
        cnt = m.sum().clamp(min=1.0)
        mean = (x * m).sum(dim=(0, 1)) / cnt
        out = x - mean * self.mean_scale
        var = ((out * out) * m).sum(dim=(0, 1)) / cnt
        return self.weight * out / torch.sqrt(var + self.eps) + self.bias


class DenseGCNConv(nn.Module):
    """PyG GCNConv(add_self_loops=False) on batched dense adjacencies:
    ``A_norm @ (x W) + b``; W glorot, U(±sqrt(6 / (fan_in + fan_out))),
    b zeros."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: torch.Generator):
        super().__init__()
        s = math.sqrt(6.0 / (in_channels + out_channels))
        weight = torch.empty(out_channels, in_channels)
        weight.uniform_(-s, s, generator=generator)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, adj_norm, adj_sum, x):
        return torch.bmm(adj_norm, F.linear(x, self.weight)) + self.bias


class DenseGINConv(nn.Module):
    """GINConv(Linear, eps=0): ``Linear(x + A_sum @ x)`` (reference:
    GNNSeg.py:161-171); the Linear keeps flax's name ``TorchLinear_0``."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: torch.Generator):
        super().__init__()
        self.TorchLinear_0 = TorchLinear(in_channels, out_channels, generator)

    def forward(self, adj_norm, adj_sum, x):
        return self.TorchLinear_0(x + torch.bmm(adj_sum, x))


CONVS = {"gcn": DenseGCNConv, "gin": DenseGINConv}


class GSegGNN(nn.Module):
    """Conv trunk with every layer's output concatenated (JK), a sum pool
    over the valid nodes and a 2-layer MLP head named ``pred`` (reference:
    GNNSeg.py:70-158, buildModel 261-280). ``in_channels`` is the feature
    width F, which flax infers from the data. Parameters are drawn on the
    CPU from a ``torch.Generator`` seeded by ``seed``, then moved to
    ``device`` ("cuda", the default, or "cpu")."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 output_channels: int, num_layers: int, *,
                 dropout: float = 0.0, activation: str = "elu",
                 conv: str = "gcn", seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        self.num_layers = num_layers
        self.act = ACTIVATIONS[activation]
        self.dropout = Dropout(dropout)
        for layer in range(num_layers):
            self.add_module(f"conv_{layer}", CONVS[conv](
                in_channels if layer == 0 else hidden_channels,
                hidden_channels, generator))
            if layer != num_layers - 1:
                self.add_module(f"gn_{layer}", MaskedGraphNorm(hidden_channels))
        self.pred = MLP(hidden_channels * num_layers, hidden_channels,
                        output_channels, 2, generator=generator,
                        dropout=dropout, activation=activation)
        self.to(dev)

    def forward(self, adj_norm: torch.Tensor, adj_sum: torch.Tensor,
                feats: torch.Tensor, mask: torch.Tensor, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C) logits of a batch: adjacencies (B, L, L), features
        (B, L, F), mask (B, L) bool. ``training=True`` turns dropout on,
        with masks drawn from ``generator``."""
        drop = dict(training=training, generator=generator)
        h = feats
        xs = []
        for layer in range(self.num_layers):
            h = getattr(self, f"conv_{layer}")(adj_norm, adj_sum, h)
            if layer != self.num_layers - 1:
                h = getattr(self, f"gn_{layer}")(h, mask)
                xs.append(h)
                h = self.dropout(self.act(h), **drop)
            else:
                xs.append(h)
        h = torch.cat(xs, dim=-1)
        # sum pool over the valid nodes (pos2sp membership SpMM,
        # GNNSeg.py:134-156)
        pooled = (h * mask[..., None]).sum(dim=1)
        return self.pred(pooled, training=training, generator=generator)

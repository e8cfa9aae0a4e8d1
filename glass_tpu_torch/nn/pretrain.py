"""The SSL link-prediction pretraining models as ``torch.nn`` modules
(counterpart of ``glass_tpu/nn/pretrain.py``; reference:
impl/models.py:361-509).

``MyGCNConv`` is the single-weight conv (no labeling trick), ``EmbGConv``
the trunk and ``EdgeGNN`` the link-prediction model whose "subgraphs" are
the two endpoints of an edge. The trunk's (N, hidden) output is the node
table GLASS warm-starts from (``--use_nodeid``; reference
GNNEmb.py:186-188, GLASSTest.py:153-157).

Submodules carry the flax names (``conv/input_emb``,
``conv/conv_i/{trans,gn,comb}``, ``conv/gn_i``, ``pred/TorchLinear_i``), so
``utils/checkpoint.py`` maps a flax ``EdgeGNN`` onto this one. The JAX
module's ``gather_global`` is the identity on one device and is dropped;
its ``dtype`` (bf16 activations) is not carried over: the pretraining
protocol never sets it. GraphNorm takes the fused kernels where
``GLASS_TPU_FUSED_NORM=1``, as in GLASS.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from glass_tpu_torch.nn import init
from glass_tpu_torch.nn.dropout import Dropout
from glass_tpu_torch.nn.modules import ACTIVATIONS, MLP, GraphNorm, TorchLinear
from glass_tpu_torch.ops._common import resolve_device
from glass_tpu_torch.ops.graph import Graph
from glass_tpu_torch.ops.segment import mean_over_nodes
from glass_tpu_torch.ops.spmm import spmm


class MyGCNConv(nn.Module):
    """act(Linear) -> ``A @ x`` -> GraphNorm -> concat the input -> Linear
    (reference: impl/models.py:361-395)."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 activation: str, spmm_mode: Optional[str],
                 generator: torch.Generator):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.spmm_mode = spmm_mode
        self.trans = TorchLinear(in_channels, out_channels, generator)
        self.gn = GraphNorm(out_channels)
        self.comb = TorchLinear(out_channels + in_channels, out_channels,
                                generator)

    def forward(self, graph: Graph, x_: torch.Tensor) -> torch.Tensor:
        x = spmm(graph, self.act(self.trans(x_)), self.spmm_mode)
        return self.comb(torch.cat([self.gn(x), x_], dim=-1))


class EmbGConv(nn.Module):
    """The pretraining trunk: embedding lookup, dropout, stacked convs with
    GraphNorm, activation and dropout between them, and the JK concat
    (reference: impl/models.py:398-475). Unlike GLASS's trunk there is no
    GraphNorm after the embedding and none after the concat, and JK
    collects each layer's *post*-norm output (impl/models.py:464-468)."""

    def __init__(self, hidden_channels: int, output_channels: int,
                 num_layers: int, max_deg: int, *, dropout: float,
                 activation: str, jk: bool, gn: bool,
                 spmm_mode: Optional[str], generator: torch.Generator):
        super().__init__()
        self.num_layers = num_layers
        self.jk = jk
        self.gn = gn
        self.act = ACTIVATIONS[activation]
        self.dropout = Dropout(dropout)
        table = torch.empty(max_deg + 1, hidden_channels)
        init.normal_embedding_(table, generator)
        self.input_emb = nn.Embedding(max_deg + 1, hidden_channels,
                                      _weight=table)
        for layer in range(num_layers):
            last = layer == num_layers - 1
            self.add_module(f"conv_{layer}", MyGCNConv(
                hidden_channels, output_channels if last else hidden_channels,
                activation=activation, spmm_mode=spmm_mode,
                generator=generator))
            if not last and gn:
                self.add_module(f"gn_{layer}", GraphNorm(hidden_channels))

    def forward(self, graph: Graph, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # x: (N,) int feature ids
        drop = dict(training=training, generator=generator)
        h = self.dropout(self.input_emb(x.reshape(-1)), **drop)
        xs = []
        for layer in range(self.num_layers):
            h = getattr(self, f"conv_{layer}")(graph, h)
            if layer != self.num_layers - 1:
                if self.gn:
                    h = getattr(self, f"gn_{layer}")(h)
                xs.append(h)
                h = self.dropout(self.act(h), **drop)
            else:
                xs.append(h)
        return torch.cat(xs, dim=-1) if self.jk else xs[-1]


class EdgeGNN(nn.Module):
    """Link prediction: the trunk, the mean of an edge's two endpoint
    embeddings and a 2-layer MLP head to one logit (reference:
    impl/models.py:478-509, assembled as GNNEmb.py:76-105).

    ``seed`` seeds the CPU ``torch.Generator`` every parameter is drawn
    from; ``device`` is "cuda" (default; raises without a card) or "cpu".
    """

    def __init__(self, max_deg: int, hidden_channels: int, num_layers: int,
                 *, dropout: float = 0.0, activation: str = "relu",
                 jk: bool = False, spmm_mode: Optional[str] = None,
                 seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        self.conv = EmbGConv(
            hidden_channels, hidden_channels, num_layers, max_deg,
            dropout=dropout, activation=activation, jk=jk, gn=True,
            spmm_mode=spmm_mode, generator=generator)
        head_in = hidden_channels * (num_layers if jk else 1)
        self.pred = MLP(head_in, hidden_channels, 1, 2, dropout=dropout,
                        activation=activation, generator=generator)
        self.to(dev)

    def node_emb(self, graph: Graph, x: torch.Tensor, training: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The trunk over each column of ``x`` (N, C), averaged (C is 1 for
        every feature the protocol sets)."""
        embs = [self.conv(graph, x[:, c], training, generator)
                for c in range(x.shape[1])]
        return sum(embs) / len(embs)

    def forward(self, graph: Graph, x: torch.Tensor, pos: torch.Tensor, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 1) f32 logits of the (B, 2) endpoint pairs in ``pos``."""
        emb = self.node_emb(graph, x, training, generator)
        return self.pred(mean_over_nodes(emb, pos), training, generator)

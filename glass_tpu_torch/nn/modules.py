"""GLASS as ``torch.nn`` modules (counterpart of ``glass_tpu/nn/modules.py``).

Submodule and parameter names follow the flax modules' names, so a flax
parameter path maps onto a ``state_dict`` key one to one
(``utils/checkpoint.py``). Parameters are drawn on the CPU from a
``torch.Generator`` seeded by ``GLASS(seed=...)`` and then moved to the
device, so one seed gives the same weights on every device.

``forward(..., training=True, generator=g)`` trains: dropout is on at the
JAX module's sites (after the conv's GraphNorm, after the embedding's
GraphNorm, after each inner layer's activation) with masks drawn from ``g``,
a ``torch.Generator`` on the model's device.

``compute_dtype="bfloat16"`` is the JAX model's mixed precision, cast for
cast at the JAX sites (not ``torch.autocast``, whose op lists put the casts
elsewhere): the embedding output is cast once; each conv's Linears cast
input, weight and bias to bf16; the SpMM's f32 output is cast to bf16;
GraphNorm reads and writes bf16 with f32 statistics; the prediction head
takes the pooled rows in f32, as bf16 @ f32 promotes in JAX. Parameters
(and so the optimizer state) stay f32.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from glass_tpu_torch.nn import init
from glass_tpu_torch.nn.dropout import Dropout
from glass_tpu_torch.ops._common import resolve_device
from glass_tpu_torch.ops.fused_norm import fused_graph_norm
from glass_tpu_torch.ops.graph import Graph
from glass_tpu_torch.ops.norm import graph_norm
from glass_tpu_torch.ops.sddmm import segment_softmax
from glass_tpu_torch.ops.segment import pool_subgraphs
from glass_tpu_torch.ops.spmm import gather_global, spmm

ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),  # jax.nn.gelu
    "tanh": torch.tanh,
}


def _mix(mask: torch.Tensor, zr: float, x1: torch.Tensor, x0: torch.Tensor):
    """The labeling-trick mix: in-batch nodes lean on the "1" branch."""
    return torch.where(mask, zr * x1 + (1 - zr) * x0, zr * x0 + (1 - zr) * x1)


COMPUTE_DTYPES = {None: None, "bfloat16": torch.bfloat16}


def _fused_norm_enabled() -> bool:
    """GLASS_TPU_FUSED_NORM: '1' takes the fused GraphNorm
    (``ops/fused_norm.py``: the CUDA kernels of ``csrc/graph_norm.cu`` on
    the card, their plain versions on the CPU), anything else the unfused
    ``ops/norm.py``; default off, as in the JAX package
    (``glass_tpu/nn/modules.py:39-51``). The card's fused-vs-unfused A/B is
    in PERF.md."""
    return os.environ.get("GLASS_TPU_FUSED_NORM", "0") == "1"


def _remat_enabled() -> bool:
    """GLASS_TPU_REMAT: '1' recomputes each GLASSConv body in the backward
    pass instead of keeping its intermediates (``torch.utils.checkpoint``),
    as ``glass_tpu/nn/modules.py:268-276`` wraps each conv in
    ``nn.remat``; anything else keeps them. Default off, as in the JAX
    package. Read at forward time; the card's memory and time, on and
    off, are in PERF.md."""
    return os.environ.get("GLASS_TPU_REMAT", "0") == "1"


class TorchLinear(nn.Module):
    """``x @ W.T + b`` with torch nn.Linear's init distribution. ``dtype``
    bf16 casts input, weight and bias to it, and rounds the product before
    adding the bias, as ``x.astype(dt) @ kernel.astype(dt) +
    bias.astype(dt)`` does in the JAX module; None computes in f32 (a bf16
    input is widened, as bf16 @ f32 promotes in JAX)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        init.torch_linear_(self.weight, self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return F.linear(x.float(), self.weight, self.bias)
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class GraphNorm(nn.Module):
    """Learnable GraphNorm with whole-graph statistics (PyG 1.7.2 GraphNorm
    with batch=None, reference impl/models.py:141,201); fused when
    ``GLASS_TPU_FUSED_NORM=1``. Given a sharded ``graph`` (x one node
    block), the statistics are all-reduced over its graph axis with the
    padding rows masked, unfused, as in JAX (``glass_tpu/nn/modules.py:
    76-95``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean_scale = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor,
                graph: Optional[Graph] = None) -> torch.Tensor:
        if graph is not None and graph.axis is not None:
            return graph_norm(x, self.weight, self.bias, self.mean_scale,
                              self.eps, axis=graph.axis,
                              node_mask=graph.node_mask(),
                              n_total=graph.n_global)
        if x.dim() == 2 and _fused_norm_enabled():
            return fused_graph_norm(x, self.weight, self.bias,
                                    self.mean_scale, self.eps)
        return graph_norm(x, self.weight, self.bias, self.mean_scale, self.eps)


class MLP(nn.Module):
    """Multi-layer perceptron with the reference's layer order
    (impl/models.py:27-80): Linear [-> GraphNorm] [-> Dropout] -> act ->
    ... -> Linear; ``tail_activation`` appends the norm, dropout and
    activation after the last Linear too. The submodules carry flax's
    automatic names (``TorchLinear_i``, ``GraphNorm_j``), so
    ``params_from_flax`` maps the JAX MLP onto this one. Where flax infers
    the first Linear's input width from the data, this one takes it as
    ``in_channels``."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 output_channels: int, num_layers: int, *,
                 generator: torch.Generator, dropout: float = 0.0,
                 tail_activation: bool = False, activation: str = "relu",
                 gn: bool = False):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.dropout = Dropout(dropout)
        self.gn = gn
        self.tail_activation = tail_activation
        widths = ([in_channels, output_channels] if num_layers == 1 else
                  [in_channels] + [hidden_channels] * (num_layers - 1)
                  + [output_channels])
        self.n_linear = len(widths) - 1
        for i in range(self.n_linear):
            self.add_module(f"TorchLinear_{i}", TorchLinear(
                widths[i], widths[i + 1], generator))
        # one GraphNorm per block: after every Linear but the last, and
        # after the last with tail_activation
        blocks = widths[1:-1] + ([output_channels] if tail_activation else [])
        if gn:
            for j, width in enumerate(blocks):
                self.add_module(f"GraphNorm_{j}", GraphNorm(width))

    def _block(self, h: torch.Tensor, j: int, drop: dict) -> torch.Tensor:
        if self.gn:
            h = getattr(self, f"GraphNorm_{j}")(h)
        return self.act(self.dropout(h, **drop))

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = dict(training=training, generator=generator)
        for i in range(self.n_linear):
            x = getattr(self, f"TorchLinear_{i}")(x)
            if i < self.n_linear - 1 or self.tail_activation:
                x = self._block(x, i, drop)
        return x


class AttentionConv(nn.Module):
    """GAT-style attention message passing on the SDDMM and segment-SpMM
    pair (``glass_tpu/nn/modules.py:151``; framework capability beyond the
    reference): score(i, j) = leaky_relu(<a_dst, W x_i> + <a_src, W x_j>),
    softmax over each row's incoming edges, then the attention-weighted
    sum of W x_j. ``att_dst`` and ``att_src`` are drawn from N(0, 0.1^2).
    The "segment" SpMM is plain ops, so the gradient reaches the
    attention weights."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 generator: torch.Generator, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.proj = TorchLinear(in_channels, out_channels, generator)
        self.att_dst = nn.Parameter(
            0.1 * torch.randn(out_channels, generator=generator))
        self.att_src = nn.Parameter(
            0.1 * torch.randn(out_channels, generator=generator))

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        h = self.proj(x)
        scores = ((h @ self.att_dst).index_select(0, graph.row)
                  + (h @ self.att_src).index_select(0, graph.col))
        att = segment_softmax(
            graph, F.leaky_relu(scores, self.negative_slope))
        return spmm(dataclasses.replace(graph, weight=att, dense=None), h,
                    "segment")


class GLASSConv(nn.Module):
    """The labeling-trick dual-weight message-passing layer (reference:
    impl/models.py:114-174): two Linears mixed by z, ``A @ x``, GraphNorm,
    dropout, concat with the input, two Linears mixed by z."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 z_ratio: float, activation: str, spmm_mode: Optional[str],
                 dropout: float, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.z_ratio = z_ratio
        self.dtype = dtype
        self.out_channels = out_channels
        self.dropout = Dropout(dropout)
        self.act = ACTIVATIONS[activation]
        self.spmm_mode = spmm_mode
        self.trans_1 = TorchLinear(in_channels, out_channels, generator, dtype)
        self.trans_0 = TorchLinear(in_channels, out_channels, generator, dtype)
        self.gn = GraphNorm(out_channels)
        self.comb_1 = TorchLinear(out_channels + in_channels, out_channels,
                                  generator, dtype)
        self.comb_0 = TorchLinear(out_channels + in_channels, out_channels,
                                  generator, dtype)

    def forward(self, graph: Graph, x_: torch.Tensor, mask: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: the dropout's keep-mask, drawn by the caller
        (``Dropout.draw``), or None to draw it here."""
        zr = self.z_ratio
        x = _mix(mask, zr, self.act(self.trans_1(x_)), self.act(self.trans_0(x_)))
        x = spmm(graph, x, self.spmm_mode)  # f32 whatever x's dtype
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.dropout(self.gn(x, graph), training=training,
                         generator=generator, rows=graph.node_rows(),
                         keep=keep)
        x = torch.cat([x, x_], dim=-1)
        return _mix(mask, zr, self.comb_1(x), self.comb_0(x))


class EmbZGConv(nn.Module):
    """GLASS trunk: integer-feature embedding + stacked GLASSConvs with
    per-layer GraphNorm/activation/dropout and Jumping-Knowledge concat
    (reference: impl/models.py:177-272). JK concatenates each conv's
    *pre-norm* output; the final GraphNorm follows the concat."""

    def __init__(self, hidden_channels: int, output_channels: int,
                 num_layers: int, max_deg: int, *, activation: str,
                 z_ratio: float, jk: bool, spmm_mode: Optional[str],
                 dropout: float, conv_dropout: float,
                 generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        self.jk = jk
        self.act = ACTIVATIONS[activation]
        self.dropout = Dropout(dropout)
        table = torch.empty(max_deg + 1, hidden_channels)
        init.normal_embedding_(table, generator)
        self.input_emb = nn.Embedding(max_deg + 1, hidden_channels,
                                      _weight=table)
        self.emb_gn = GraphNorm(hidden_channels)
        for layer in range(num_layers):
            last = layer == num_layers - 1
            self.add_module(f"conv_{layer}", GLASSConv(
                hidden_channels,
                output_channels if last else hidden_channels,
                z_ratio=z_ratio, activation=activation, spmm_mode=spmm_mode,
                dropout=conv_dropout, generator=generator, dtype=dtype,
            ))
            if not last:
                self.add_module(f"gn_{layer}", GraphNorm(hidden_channels))
        out_features = (hidden_channels * (num_layers - 1) + output_channels
                        if jk else output_channels)
        self.gn_out = GraphNorm(out_features)

    def forward(self, graph: Graph, x: torch.Tensor,
                z: Optional[torch.Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # x: (N,) int feature ids; z: (N,) zero-one labels or None.
        if z is None:
            # reference parity: z=None means an all-TRUE mask (every node
            # uses the "1" branch), NOT the same as an all-zero z
            mask = torch.ones((x.shape[0], 1), dtype=torch.bool,
                              device=x.device)
        else:
            mask = (z > 0.5).reshape(-1, 1)
        drop = dict(training=training, generator=generator)
        rows = graph.node_rows()
        h = self.input_emb(x)
        if self.dtype is not None:
            h = h.to(self.dtype)  # once, after the table gather
        h = self.dropout(self.emb_gn(h, graph), **drop, rows=rows)
        remat = torch.is_grad_enabled() and _remat_enabled()
        xs = []
        for layer in range(self.num_layers):
            conv = getattr(self, f"conv_{layer}")
            if remat:
                # checkpoint does not restore an explicit generator, so the
                # conv's one draw (its dropout, the first after its start:
                # the generator's sequence is the one without remat) is
                # made before the body that runs again in the backward
                keep = conv.dropout.draw((h.shape[0], conv.out_channels),
                                         h.device, **drop, rows=rows)
                h = checkpoint(conv, graph, h, mask, **drop, keep=keep,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = conv(graph, h, mask, **drop)
            xs.append(h)
            if layer != self.num_layers - 1:
                h = self.act(getattr(self, f"gn_{layer}")(h, graph))
                h = self.dropout(h, **drop, rows=rows)
        h = torch.cat(xs, dim=-1) if self.jk else xs[-1]
        return self.gn_out(h, graph)


class GLASS(nn.Module):
    """Full GLASS model: trunk + per-task pooling + per-task Linear head
    (reference: impl/models.py:322-355, GLASSTest.py:129-175).

    ``dropout`` is the trunk's rate and ``conv_dropout`` the convs' (default:
    ``dropout``). ``compute_dtype`` None (f32) or "bfloat16" (the JAX
    module's ``dtype``: mixed precision, see the module docstring).
    ``seed`` seeds the CPU ``torch.Generator`` every parameter is drawn
    from; ``device`` is "cuda" (default; raises without a card) or "cpu".
    """

    def __init__(self, max_deg: int, hidden_channels: int, num_layers: int,
                 output_channels: Sequence[int], pools: Sequence[str], *,
                 dropout: float = 0.0, conv_dropout: Optional[float] = None,
                 activation: str = "elu", z_ratio: float = 0.8,
                 jk: bool = True, spmm_mode: Optional[str] = None,
                 compute_dtype: Optional[str] = None,
                 seed: int = 0, device="cuda"):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}: use None "
                             "(f32) or 'bfloat16'")
        dtype = COMPUTE_DTYPES[compute_dtype]
        dev = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        self.pools = tuple(pools)
        self.conv = EmbZGConv(
            hidden_channels, hidden_channels, num_layers, max_deg,
            activation=activation, z_ratio=z_ratio, jk=jk,
            spmm_mode=spmm_mode, dropout=dropout,
            conv_dropout=dropout if conv_dropout is None else conv_dropout,
            generator=generator, dtype=dtype,
        )
        emb_dim = hidden_channels * num_layers if jk else hidden_channels
        for i, c in enumerate(output_channels):
            self.add_module(f"pred_{i}", TorchLinear(emb_dim, c, generator))
        self.to(dev)

    def node_emb(self, graph: Graph, x: torch.Tensor,
                 z: Optional[torch.Tensor] = None, training: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-channel trunk application, averaged (reference NodeEmb,
        impl/models.py:336-344; the channel dim is 1 in every config)."""
        embs = [self.conv(graph, x[:, c], z, training, generator)
                for c in range(x.shape[1])]
        return sum(embs) / len(embs)

    def forward(self, graph: Graph, x: torch.Tensor, pos: torch.Tensor,
                z: Optional[torch.Tensor] = None, *, training: bool = False,
                generator: Optional[torch.Generator] = None,
                id: int = 0) -> torch.Tensor:
        """(B, C) f32 logits of the subgraphs in ``pos`` (padded with -1).
        ``training=True`` turns dropout on, with masks drawn from
        ``generator``. On a sharded graph (x and z this rank's node block)
        the embeddings are all-gathered over the graph axis before pooling,
        and ``pos`` holds global node ids."""
        emb = gather_global(graph, self.node_emb(graph, x, z, training,
                                                 generator))
        pooled = pool_subgraphs(emb, pos, self.pools[id])
        return getattr(self, f"pred_{id}")(pooled)

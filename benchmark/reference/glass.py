"""GLASS written out in plain PyTorch: a frozen copy of the equations that
the benchmark holds the program against.

The model (the reference implementation's ``impl/models.py:114-355`` and
``GLASSTest.py:129-175``, as the GLASS paper, ICLR 2022, describes it):

  h0   = Dropout(GraphNorm(E[x]))                       E: the id table
  per conv layer l, input h, z the zero-one labels of the batch's nodes:
    t    = mix(z, act(h W1^T + b1), act(h W0^T + b0))
    a    = Dropout(GraphNorm(A t))                      A: gcn-normalized
    h'   = mix(z, [a, h] C1^T + c1, [a, h] C0^T + c0)
    between layers: h = Dropout(act(GraphNorm(h')))
  emb  = GraphNorm(concat of every layer's h')          (jumping knowledge)
  out  = pool(emb over each subgraph) P^T + p

  mix(z, u1, u0) = zr u1 + (1 - zr) u0 where z = 1, zr u0 + (1 - zr) u1
  GraphNorm(x)  = w (x - alpha mean(x)) / sqrt(mean((x - alpha mean(x))^2)
                  + 1e-5) + b, over all nodes, per feature
  A             = D^-1/2 W D^-1/2 with D the row sums of the (multi)graph's
                  edge counts, an isolated row's degree counted as 1
  Dropout(x)    = keep ? x / (1 - rate) : 0

Training is the loss (BCE on logits or cross entropy), its gradient by
autograd, and Adam (betas 0.9 / 0.999, eps 1e-8, no weight decay) written
out. Every product is f32 with TF32 off unless the caller turns TF32 on
(the control). ``A x`` is an ``index_add`` over the edge list in blocks of
edges, and its backward the same over the transposed list.

Parameter names are the program's ``state_dict`` keys, so that the
benchmark can hand one set of initial weights to both.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

EDGE_BLOCK = 1 << 21  # edges gathered at a time by A x
BETAS, ADAM_EPS, NORM_EPS = (0.9, 0.999), 1e-8, 1e-5
ACTIVATIONS = {"elu": F.elu, "relu": F.relu, "tanh": torch.tanh}


@contextlib.contextmanager
def precision(tf32: bool):
    """f32 products with TF32 off (the reference), or on (the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def param_shapes(model: dict, max_id: int, out_channels: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, kind) of every parameter. Kinds: ``linear:<fan in>``,
    ``embedding``, ``norm_one`` (GraphNorm's weight and mean scale),
    ``norm_zero`` (its bias)."""
    h, layers = model["hidden_dim"], model["conv_layer"]
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def norm(prefix, f):
        shapes[f"{prefix}.weight"] = ((f,), "norm_one")
        shapes[f"{prefix}.bias"] = ((f,), "norm_zero")
        shapes[f"{prefix}.mean_scale"] = ((f,), "norm_one")

    def linear(prefix, fin, fout):
        shapes[f"{prefix}.weight"] = ((fout, fin), f"linear:{fin}")
        shapes[f"{prefix}.bias"] = ((fout,), f"linear:{fin}")

    shapes["conv.input_emb.weight"] = ((max_id + 1, h), "embedding")
    norm("conv.emb_gn", h)
    for layer in range(layers):
        c = f"conv.conv_{layer}"
        linear(f"{c}.trans_1", h, h)
        linear(f"{c}.trans_0", h, h)
        norm(f"{c}.gn", h)
        linear(f"{c}.comb_1", 2 * h, h)
        linear(f"{c}.comb_0", 2 * h, h)
        if layer != layers - 1:
            norm(f"conv.gn_{layer}", h)
    emb = h * layers if model["jk"] else h
    norm("conv.gn_out", emb)
    linear("pred_0", emb, out_channels)
    return shapes


class Adjacency:
    """The gcn-normalized adjacency of a directed edge list, worked out from
    the edges alone: ``weight[e] = d[row]^-1/2 d[col]^-1/2`` with ``d`` the
    row's edge count (repeated edges count each time; a row with none
    counts 1)."""

    def __init__(self, edge_index: torch.Tensor, n: int, aggr: str = "gcn"):
        if aggr != "gcn":
            raise NotImplementedError(
                f"the reference has gcn only, not {aggr}")
        self.row = edge_index[0].long()
        self.col = edge_index[1].long()
        self.n = n
        deg = torch.bincount(self.row, minlength=n).double()
        deg[deg < 0.5] += 1.0
        dinv = deg.rsqrt()
        self.weight = (dinv[self.row] * dinv[self.col]).float()


def _edge_sum(out_rows: torch.Tensor, in_rows: torch.Tensor,
              weight: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    for s in range(0, out_rows.shape[0], EDGE_BLOCK):
        e = slice(s, s + EDGE_BLOCK)
        out.index_add_(0, out_rows[e], x[in_rows[e]] * weight[e, None])
    return out


class _Propagate(torch.autograd.Function):
    """A x forward, A^T g backward, both as edge sums."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return _edge_sum(adj.row, adj.col, adj.weight, x, adj.n)

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        return _edge_sum(adj.col, adj.row, adj.weight, g, adj.n), None


def graph_norm(x, w, b, alpha):
    mean = x.mean(dim=0)
    out = x - mean * alpha
    var = (out * out).mean(dim=0)
    return w * out / torch.sqrt(var + NORM_EPS) + b


def mix(mask, zr, u1, u0):
    return torch.where(mask, zr * u1 + (1 - zr) * u0, zr * u0 + (1 - zr) * u1)


def dropout(x, keep, rate):
    return x if keep is None else torch.where(keep, x / (1.0 - rate), 0.0)


def pool(emb: torch.Tensor, pos: torch.Tensor, kind: str) -> torch.Tensor:
    """Each subgraph's pooled embedding (pos padded with -1)."""
    mask = (pos >= 0)[..., None]
    g = torch.where(mask, emb[pos.clamp(min=0)], 0.0)
    count = mask.sum(dim=1).float().clamp(min=1.0)
    if kind == "sum":
        return g.sum(dim=1)
    if kind == "mean":
        return g.sum(dim=1) / count
    if kind == "size":
        return g.sum(dim=1) / count.sqrt()
    if kind == "max":
        m = torch.where(mask, g, float("-inf")).amax(dim=1)
        return torch.where(mask.any(dim=1), m, 0.0)
    raise ValueError(f"unknown pool {kind!r}")


def batch_mask(pos: torch.Tensor, n: int, use_z: bool) -> torch.Tensor:
    """(n, 1) bool: the nodes of any subgraph of the batch (all True
    without the labeling trick)."""
    if not use_z:
        return torch.ones((n, 1), dtype=torch.bool, device=pos.device)
    m = torch.zeros(n, dtype=torch.bool, device=pos.device)
    m[pos[pos >= 0]] = True
    return m[:, None]


def draw_masks(gen: Optional[torch.Generator], model: dict, n: int,
               device) -> List[Optional[torch.Tensor]]:
    """One training step's dropout keep-masks, in the order the model's
    sites draw them (after the embedding's norm; per layer after the
    conv's norm and, between layers, after the activation), each
    ``rand(n, hidden) >= rate`` from ``gen``. None without dropout."""
    rate, h = model["dropout"], model["hidden_dim"]
    layers = model["conv_layer"]
    sites = 1 + layers + (layers - 1)
    if gen is None or rate == 0.0:
        return [None] * sites
    return [torch.rand((n, h), generator=gen, device=device) >= rate
            for _ in range(sites)]


def forward(p: Dict[str, torch.Tensor], model: dict, adj: Adjacency,
            ids: torch.Tensor, pos: torch.Tensor,
            masks: Optional[Sequence[Optional[torch.Tensor]]] = None
            ) -> torch.Tensor:
    """(B, C) logits of the subgraphs ``pos`` (padded with -1); ``masks``
    from :func:`draw_masks` (training) or None (inference)."""
    layers, zr, rate = model["conv_layer"], model["z_ratio"], model["dropout"]
    act = ACTIVATIONS[model["activation"]]
    masks = list(masks) if masks is not None else [None] * (2 * layers)
    mask = batch_mask(pos, adj.n, model["use_maxzeroone"])

    def lin(name, v):
        return F.linear(v, p[f"{name}.weight"], p[f"{name}.bias"])

    def gn(name, v):
        return graph_norm(v, p[f"{name}.weight"], p[f"{name}.bias"],
                          p[f"{name}.mean_scale"])

    h = p["conv.input_emb.weight"][ids[:, 0]]
    h = dropout(gn("conv.emb_gn", h), masks.pop(0), rate)
    outs = []
    for layer in range(layers):
        c = f"conv.conv_{layer}"
        t = mix(mask, zr, act(lin(f"{c}.trans_1", h)),
                act(lin(f"{c}.trans_0", h)))
        a = dropout(gn(f"{c}.gn", _Propagate.apply(t, adj)), masks.pop(0),
                    rate)
        cat = torch.cat([a, h], dim=-1)
        h = mix(mask, zr, lin(f"{c}.comb_1", cat), lin(f"{c}.comb_0", cat))
        outs.append(h)
        if layer != layers - 1:
            h = dropout(act(gn(f"conv.gn_{layer}", h)), masks.pop(0), rate)
    emb = gn("conv.gn_out", torch.cat(outs, dim=-1) if model["jk"] else h)
    return lin("pred_0", pool(emb, pos, model["pool"]))


def loss_of(logits: torch.Tensor, y: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bce":
        return F.binary_cross_entropy_with_logits(logits.reshape(-1),
                                                  y.float().reshape(-1))
    if kind == "ce":
        return F.cross_entropy(logits, y.long())
    raise ValueError(f"unknown loss {kind!r}")


class Adam:
    """Adam written out: m, v, and the bias-corrected update."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        b1, b2 = BETAS
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            den = (self.v[k] / c2).sqrt() + ADAM_EPS
            out[k] = p - self.lr * (self.m[k] / c1) / den
        return out


def train_steps(params: Dict[str, torch.Tensor], model: dict, adj: Adjacency,
                ids: torch.Tensor, batches: Sequence[Tuple[torch.Tensor,
                                                           torch.Tensor]],
                dropout_seed: Optional[int], *, half_batch: bool = False
                ) -> dict:
    """Steps of training from ``params`` over ``batches`` of (pos, y), the
    masks drawn from a generator seeded with ``dropout_seed`` on the
    inputs' device. Returns each step's loss, each leaf's first gradient
    and the parameters after the last step. ``half_batch`` plants a fault:
    the loss is the mean over the first half of each batch only."""
    device = ids.device
    gen = (None if dropout_seed is None else
           torch.Generator(device=device).manual_seed(dropout_seed))
    p = {k: v.detach().clone().float() for k, v in params.items()}
    opt = Adam(p, model["lr"])
    losses, first_grad = [], None
    for pos, y in batches:
        masks = draw_masks(gen, model, adj.n, device)
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        logits = forward(leaves, model, adj, ids, pos, masks)
        if half_batch:
            keep = pos.shape[0] // 2
            logits, y = logits[:keep], y[:keep]
        loss = loss_of(logits, y, model["loss"])
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            p = opt.step({k: v.detach() for k, v in leaves.items()}, grads)
    return dict(losses=losses, first_grad=first_grad, params=p)


@torch.no_grad()
def predict(params: Dict[str, torch.Tensor], model: dict, adj: Adjacency,
            ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Inference logits of one request's subgraphs."""
    return forward(params, model, adj, ids, pos)


def norm(t: torch.Tensor) -> float:
    return math.sqrt(float((t.double() ** 2).sum()))

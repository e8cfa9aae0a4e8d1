"""Fused whole-graph GraphNorm, forward and backward (counterpart of
``glass_tpu/ops/pallas_norm.py``).

The PyG 1.7.2 formula of ``ops/norm.py`` in the fewest passes over the
(N, F) activations, as the JAX module does it:

forward:   K1  S1 = sum_n x                 -> mu = S1/N, am = mean_scale*mu
           K2  S2 = sum_n (x - am)^2        -> var = S2/N (the exact two-pass
               variance: the reference formula is not re-centred),
               s = rsqrt(var + eps), g = w*s, h = b - g*mean_scale*mu
           K3  y  = g*x + h
backward:  K4  R1 = sum_n dy, R2 = sum_n dy*(x - am)
               -> a, c2, c1, dw = s*R2, db = R1,
                  dalpha = -w*mu*s*R1 + w*mu*mo*s^3*R2
           K5  dx = a*dy + c2*x + c1

Each reduction finishes the per-feature algebra that follows it, copied
expression for expression from ``_stats``, ``_fwd`` and ``_bwd``
(``pallas_norm.py:155-160, 172-207``), where JAX runs it in jnp between
its kernels: a reduction returns its raw sums first and the derived (F,)
vectors beside them. So the autograd Function runs the five passes and no
tensor operation of its own. Residuals are x, am, mu and var. Statistics
are f32; y and dx have x's dtype (f32 or bf16); the parameters are (F,)
f32.

A CUDA tensor goes to the hand-written kernels of ``csrc/graph_norm.cu``
(built at first use): one launch per pass, the reductions finishing in
the last CTA to arrive (``reduce_grid``; a workspace kept per device and
stream), the elementwise passes walking the flat (N*F) stream in 16-byte
chunks on persistent CTAs (``elementwise_plan``). A CPU tensor goes to
the plain versions below, the same five passes in plain PyTorch. There is
no fallback between the two.
``fused_graph_norm_reference`` runs the plain passes on any device.
``fused_graph_norm.launches`` counts the CUDA kernel launches;
``fused_graph_norm.launches_by_kernel`` counts the passes by name and
``fused_graph_norm.launches_by_dtype`` by x's dtype.
"""

from __future__ import annotations

import functools
import math
import struct
from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops._common import on_card

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/graph_norm.cu
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_RED_SUM, _RED_VAR, _RED_BWD = 0, 1, 2
_EW_AFFINE, _EW_DX = 0, 1
# the TPU kernels' names, one per pass (glass_tpu/ops/pallas_norm.py), and
# the CUDA launches of each pass
KERNELS = ("colsum", "varsum", "affine", "bwd_reduce", "bwd_dx")
LAUNCHES_PER_PASS = {k: 1 for k in KERNELS}
# each reduction's outputs, rows of one (rows, F) f32 tensor: its raw sums
# first (SUMS of them), then the derived vectors
OUTPUTS = {"colsum": ("s1", "mu", "am"),
           "varsum": ("s2", "var", "g", "h"),
           "bwd_reduce": ("r1", "r2", "a", "c2", "c1", "dw", "db", "dalpha")}
SUMS = {"colsum": 1, "varsum": 1, "bwd_reduce": 2}
# csrc/graph_norm.cu: threads of a reduction's CTA (one CTA an SM), and the
# byte of its workspace where the partials start
RED_THREADS = 512
PARTIALS_OFFSET = 256
# csrc/graph_norm.cu: threads of an elementwise (K3, K5) CTA, and its CTAs
# an SM
EW_THREADS = 256
EW_CTAS_PER_SM = 2
# the entry points' packed arguments, one 8-byte field each
# (csrc/graph_norm.cu ReduceArgs, ElementwiseArgs)
_REDUCE_ARGS = struct.Struct("<11qd6q")
_ELEMENTWISE_ARGS = struct.Struct("<14q")


# ----------------------------------------------------------- plain versions


def colsum_reference(x: torch.Tensor, mean_scale: torch.Tensor) -> tuple:
    """K1: (S1, mu, am), (F,) f32 each: the column sums of x, mu = S1/N and
    am = mean_scale*mu."""
    s1 = x.float().sum(0)
    mu = s1 / x.shape[0]
    return s1, mu, mean_scale * mu


def varsum_reference(x: torch.Tensor, am: torch.Tensor, mu: torch.Tensor,
                     mean_scale: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> tuple:
    """K2: (S2, var, g, h), (F,) f32 each: the column sums of (x - am)^2,
    var = S2/N, g = w*rsqrt(var + eps) and h = b - g*mean_scale*mu."""
    d = x.float() - am
    s2 = (d * d).sum(0)
    var = s2 / x.shape[0]
    g = weight * torch.rsqrt(var + eps)
    return s2, var, g, bias - g * mean_scale * mu


def affine_reference(x: torch.Tensor, g: torch.Tensor,
                     h: torch.Tensor) -> torch.Tensor:
    """K3: x*g + h in f32, rounded once to x's dtype."""
    return (x.float() * g + h).to(x.dtype)


def bwd_reduce_reference(dy: torch.Tensor, x: torch.Tensor, am: torch.Tensor,
                         mu: torch.Tensor, var: torch.Tensor,
                         weight: torch.Tensor, mean_scale: torch.Tensor,
                         eps: float) -> tuple:
    """K4: (R1, R2, a, c2, c1, dw, db, dalpha), (F,) f32 each: the column
    sums of dy and of dy*(x - am), then ``_bwd``'s per-feature algebra."""
    dyf = dy.float()
    r1, r2 = dyf.sum(0), (dyf * (x.float() - am)).sum(0)
    n = x.shape[0]
    s = torch.rsqrt(var + eps)
    mo = mu * (1.0 - mean_scale)  # mean(x - alpha*mu)
    c2 = -(weight * s**3 / n) * r2
    # dx_j = a*dy_j - (w*alpha*s/n)*R1 - (w*s^3/n)*R2*(x_j - alpha*mu - alpha*mo)
    c1 = -(weight * mean_scale * s / n) * r1 - c2 * (
        mean_scale * mu + mean_scale * mo)
    dalpha = -weight * mu * s * r1 + weight * mu * mo * s**3 * r2
    return r1, r2, weight * s, c2, c1, s * r2, r1, dalpha


def bwd_dx_reference(dy: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                     c2: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """K5: dy*a + x*c2 + c1 in f32, rounded once to x's dtype."""
    return (dy.float() * a + x.float() * c2 + c1).to(x.dtype)


PLAIN = SimpleNamespace(colsum=colsum_reference, varsum=varsum_reference,
                        affine=affine_reference,
                        bwd_reduce=bwd_reduce_reference,
                        bwd_dx=bwd_dx_reference)


# ------------------------------------------------------------------ kernels


class ReduceGrid(NamedTuple):
    """The launch of one reduction (``csrc/graph_norm.cu`` reduce_kernel)."""
    p: int                # CTAs down the rows: grid x, partial rows
    col_tiles: int        # grid y: RED_THREADS column groups each
    rows_per_tile: int    # rows one grid-stride step of a CTA reads
    rows_per_cta: int     # the most rows one CTA reads
    workspace_bytes: int  # the counter, then sums * p * F f32 partials


@functools.lru_cache(maxsize=256)
def reduce_grid(n: int, f: int, v: int, sums: int, sm_count: int) -> ReduceGrid:
    """One CTA per SM (all resident in one wave), fewer where there are
    fewer row tiles; each thread loads v values of a row at once."""
    groups = -(-f // v)
    tile_groups = min(groups, RED_THREADS)
    rows = RED_THREADS // tile_groups
    tiles = -(-n // rows)
    p = max(1, min(sm_count, tiles))
    return ReduceGrid(p, -(-groups // tile_groups), rows,
                      min(n, -(-tiles // p) * rows),
                      PARTIALS_OFFSET + sums * p * f * 4)


class ElementwisePlan(NamedTuple):
    """The launch of K3 or K5 (``csrc/graph_norm.cu`` elementwise_kernel):
    thread t < live takes chunks t, t + live, t + 2*live, ... of the flat
    (N*F) stream, v elements each, the last one partial where v does not
    divide N*F."""
    ctas: int               # grid: at most EW_CTAS_PER_SM an SM
    threads: int            # threads of a CTA (EW_THREADS)
    live: int               # threads that walk: a multiple of the period
    v: int                  # elements per chunk: 16 bytes, or 1
    chunks_per_thread: int  # the most chunks one thread takes


@functools.lru_cache(maxsize=256)
def elementwise_plan(n: int, f: int, itemsize: int, aligned: bool,
                     sm_count: int) -> ElementwisePlan:
    """K3's or K5's launch at (n, f), n*f >= 1: 16-byte chunks where
    every operand is 16-byte aligned, else one value. The columns repeat
    every period = f / gcd(f, v) chunks, so ``live``, the walking threads,
    is the largest multiple of it that fits in one wave of EW_CTAS_PER_SM
    CTAs an SM (at least one period, at most the periods there are), and
    each thread's chunks all start at one column. The grid covers
    min(live, chunks) threads, since a thread past the chunks has nothing
    to do (live may exceed the grid where one period is longer than the
    chunks), and every CTA launched has a chunk."""
    v = 16 // itemsize if aligned else 1
    chunks = -(-(n * f) // v)
    period = f // math.gcd(f, v)
    wave = sm_count * EW_CTAS_PER_SM * EW_THREADS
    live = period * max(1, min(wave // period, -(-chunks // period)))
    return ElementwisePlan(-(-min(live, chunks) // EW_THREADS), EW_THREADS,
                           live, v, -(-chunks // live))


_SM_COUNT: Dict[int, int] = {}
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


def _sm_count(index: int) -> int:
    sms = _SM_COUNT.get(index)
    if sms is None:
        sms = _build.load("graph_norm").glass_norm_sm_count(index)
        if sms < 1:
            raise RuntimeError(f"graph_norm: no SM count for cuda:{index}")
        _SM_COUNT[index] = sms
    return sms


def _workspace(device: torch.device, stream: int,
               nbytes: int) -> torch.Tensor:
    """The reductions' workspace on ``stream``, zeroed when made and left
    zeroed by every launch; grown to the largest size asked for."""
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < nbytes:
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        _WORKSPACE[key] = ws
    return ws


def _check(name: str, x: torch.Tensor, others=(), vecs=()) -> None:
    """The rules every pass holds its operands to: (N, F) x of f32 or
    bf16, other (N, F) operands of x's dtype, (F,) f32 vectors, one device,
    contiguous."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (N, F), got {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16 x, not {x.dtype}")
    shape, dtype, device = x.shape, x.dtype, x.device
    for t in others:
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} "
                             f"does not match x {tuple(shape)} {dtype}")
    f = (shape[1],)
    for v in vecs:
        if v.shape != f or v.dtype != torch.float32:
            raise ValueError(f"{name}: per-feature vectors are ({shape[1]},) "
                             f"float32, got {tuple(v.shape)} {v.dtype}")
    for t in (*others, *vecs):
        if t.device != device:
            raise ValueError(f"{name}: operands lie on several devices")
    for t in (x, *others, *vecs):
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def _count(kernel: str, x: torch.Tensor) -> None:
    fused_graph_norm.launches += LAUNCHES_PER_PASS[kernel]
    by = fused_graph_norm.launches_by_kernel
    by[kernel] = by.get(kernel, 0) + 1
    by, key = fused_graph_norm.launches_by_dtype, DTYPE_NAMES[x.dtype]
    by[key] = by.get(key, 0) + 1


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _reduce(kernel: str, mode: int, x: torch.Tensor,
            dy: Optional[torch.Tensor], vecs: tuple, eps: float) -> tuple:
    """The kernel's outputs (OUTPUTS[kernel]), rows of one f32 tensor,
    through its one launch. ``vecs`` is (am, mu, var, mean_scale, weight,
    bias), None where the mode reads none."""
    n, f = x.shape
    out = torch.empty((len(OUTPUTS[kernel]), f), dtype=torch.float32,
                      device=x.device)
    if f == 0:
        return out.unbind()
    index, xp, dp = x.get_device(), x.data_ptr(), _ptr(dy)
    vmax = 16 // x.element_size()
    v = vmax if f % vmax == 0 and (xp | dp) % 16 == 0 else 1
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # several microseconds a call
    stream = torch._C._cuda_getCurrentRawStream(index)
    grid = reduce_grid(n, f, v, SUMS[kernel], _sm_count(index))
    ws = _workspace(x.device, stream, grid.workspace_bytes)
    args = _REDUCE_ARGS.pack(
        mode, xp, dp, DTYPE_CODES[x.dtype], v, *map(_ptr, vecs), eps,
        out.data_ptr(), ws.data_ptr(), n, f, grid.p, stream)
    _build.launch(f"graph_norm {kernel}",
                  _build.load("graph_norm").glass_norm_reduce, index, args)
    _count(kernel, x)
    return out.unbind()


def _elementwise(kernel: str, mode: int, x: torch.Tensor,
                 dy: Optional[torch.Tensor], vecs: tuple) -> torch.Tensor:
    """(N, F) of x's dtype through the kernel's one launch. ``vecs`` is
    (g, h, None) or (a, c2, c1)."""
    n, f = x.shape
    out = torch.empty_like(x)
    if n == 0 or f == 0:
        return out
    index, xp, dp, op = x.get_device(), x.data_ptr(), _ptr(dy), out.data_ptr()
    plan = elementwise_plan(n, f, x.element_size(), (xp | dp | op) % 16 == 0,
                            _sm_count(index))
    args = _ELEMENTWISE_ARGS.pack(
        mode, DTYPE_CODES[x.dtype], plan.v, xp, dp, *map(_ptr, vecs), op,
        n * f, f, plan.ctas, plan.live,
        torch._C._cuda_getCurrentRawStream(index))
    _build.launch(f"graph_norm {kernel}",
                  _build.load("graph_norm").glass_norm_elementwise, index,
                  args)
    _count(kernel, x)
    return out


def colsum(x: torch.Tensor, mean_scale: torch.Tensor) -> tuple:
    """K1 (``_colsum_kernel``): (S1, mu, am), as colsum_reference."""
    _check("colsum", x, vecs=(mean_scale,))
    if not on_card("colsum", x):
        return colsum_reference(x, mean_scale)
    return _reduce("colsum", _RED_SUM, x, None,
                   (None, None, None, mean_scale, None, None), 0.0)


def varsum(x: torch.Tensor, am: torch.Tensor, mu: torch.Tensor,
           mean_scale: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           eps: float) -> tuple:
    """K2 (``_varsum_kernel``): (S2, var, g, h), as varsum_reference."""
    _check("varsum", x, vecs=(am, mu, mean_scale, weight, bias))
    if not on_card("varsum", x):
        return varsum_reference(x, am, mu, mean_scale, weight, bias, eps)
    return _reduce("varsum", _RED_VAR, x, None,
                   (am, mu, None, mean_scale, weight, bias), eps)


def affine(x: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """K3 (``_affine_kernel``): x*g + h in x's dtype."""
    _check("affine", x, vecs=(g, h))
    if not on_card("affine", x):
        return affine_reference(x, g, h)
    return _elementwise("affine", _EW_AFFINE, x, None, (g, h, None))


def bwd_reduce(dy: torch.Tensor, x: torch.Tensor, am: torch.Tensor,
               mu: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
               mean_scale: torch.Tensor, eps: float) -> tuple:
    """K4 (``_bwd_reduce_kernel``): (R1, R2, a, c2, c1, dw, db, dalpha), as
    bwd_reduce_reference."""
    _check("bwd_reduce", x, others=(dy,),
           vecs=(am, mu, var, weight, mean_scale))
    if not on_card("bwd_reduce", x):
        return bwd_reduce_reference(dy, x, am, mu, var, weight, mean_scale,
                                    eps)
    return _reduce("bwd_reduce", _RED_BWD, x, dy,
                   (am, mu, var, mean_scale, weight, None), eps)


def bwd_dx(dy: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
           c2: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """K5 (``_bwd_dx_kernel``): dy*a + x*c2 + c1 in x's dtype."""
    _check("bwd_dx", x, others=(dy,), vecs=(a, c2, c1))
    if not on_card("bwd_dx", x):
        return bwd_dx_reference(dy, x, a, c2, c1)
    return _elementwise("bwd_dx", _EW_DX, x, dy, (a, c2, c1))


KERNEL = SimpleNamespace(colsum=colsum, varsum=varsum, affine=affine,
                         bwd_reduce=bwd_reduce, bwd_dx=bwd_dx)


# ----------------------------------------------------------------- autograd


class _FusedGraphNorm(torch.autograd.Function):
    """``pallas_norm.py``'s custom VJP, ``_fwd`` and ``_bwd``, as the five
    passes of ``passes`` (KERNEL or PLAIN) and nothing between them."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean_scale, eps, passes):
        _, mu, am = passes.colsum(x, mean_scale)
        _, var, g, h = passes.varsum(x, am, mu, mean_scale, weight, bias, eps)
        y = passes.affine(x, g, h)
        ctx.save_for_backward(x, am, mu, var, weight, mean_scale)
        ctx.eps, ctx.passes = eps, passes
        return y

    @staticmethod
    def backward(ctx, dy):
        x, am, mu, var, weight, mean_scale = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        _, _, a, c2, c1, dw, db, dalpha = ctx.passes.bwd_reduce(
            dy, x, am, mu, var, weight, mean_scale, ctx.eps)
        dx = ctx.passes.bwd_dx(dy, x, a, c2, c1)
        return dx, dw, db, dalpha, None, None


def fused_graph_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, mean_scale: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Drop-in fused equivalent of ``ops/norm.py::graph_norm`` for (N, F) f32
    or bf16 x with (F,) f32 parameters; differentiable in all four. The
    passes run the CUDA kernels for a CUDA x and the plain versions for a
    CPU x, and raise on operands they do not take."""
    return _FusedGraphNorm.apply(x.contiguous(), weight, bias, mean_scale,
                                 float(eps), KERNEL)


def fused_graph_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, mean_scale: torch.Tensor,
                               eps: float = 1e-5) -> torch.Tensor:
    """:func:`fused_graph_norm` with the plain passes, on any device."""
    return _FusedGraphNorm.apply(x.contiguous(), weight, bias, mean_scale,
                                 float(eps), PLAIN)


fused_graph_norm.launches = 0
fused_graph_norm.launches_by_kernel = {}
fused_graph_norm.launches_by_dtype = {}

"""Fused whole-graph GraphNorm, forward and backward (counterpart of
``glass_tpu/ops/pallas_norm.py``).

The PyG 1.7.2 formula of ``ops/norm.py`` in the fewest passes over the
(N, F) activations, as the JAX module does it:

forward:   K1  S1 = sum_n x                 -> mu = S1/N, am = mean_scale*mu
           K2  S2 = sum_n (x - am)^2        -> var = S2/N (the exact two-pass
               variance: the reference formula is not re-centred)
           K3  y  = g*x + h,  s = rsqrt(var + eps), g = w*s,
               h = b - g*mean_scale*mu
backward:  K4  R1 = sum_n dy, R2 = sum_n dy*(x - am)
           K5  dx = a*dy + c2*x + c1
           dw = s*R2, db = R1, dalpha = -w*mu*s*R1 + w*mu*mo*s^3*R2

The per-feature algebra between the passes is copied expression for
expression from ``_fwd`` and ``_bwd`` (``pallas_norm.py:172-207``) and runs
in PyTorch, as JAX runs it in jnp outside its kernels. Residuals are x, mu
and var. Statistics are f32; y and dx have x's dtype (f32 or bf16).

A CUDA tensor goes to the hand-written kernels of ``csrc/graph_norm.cu``
(built at first use); a CPU tensor goes to the plain versions below, the
same five passes in plain PyTorch. There is no fallback between the two.
``fused_graph_norm_reference`` runs the plain passes on any device.
``fused_graph_norm.launches`` counts the CUDA kernel launches (K1, K2 and
K4 are two launches each: the partial sums and the fixed-order finish
pass); ``fused_graph_norm.launches_by_kernel`` counts the passes by name
and ``fused_graph_norm.launches_by_dtype`` by x's dtype.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/graph_norm.cu
_RED_SUM, _RED_VAR, _RED_BWD = 0, 1, 2
_EW_AFFINE, _EW_DX = 0, 1
# the TPU kernels' names, one per pass (glass_tpu/ops/pallas_norm.py), and
# the CUDA launches of each pass: a reduction is its partial pass and the
# fixed-order finish pass
KERNELS = ("colsum", "varsum", "affine", "bwd_reduce", "bwd_dx")
LAUNCHES_PER_PASS = {"colsum": 2, "varsum": 2, "affine": 1, "bwd_reduce": 2,
                     "bwd_dx": 1}


# ----------------------------------------------------------- plain versions


def colsum_reference(x: torch.Tensor) -> torch.Tensor:
    """K1: (F,) f32 column sums of x."""
    return x.float().sum(0)


def varsum_reference(x: torch.Tensor, am: torch.Tensor) -> torch.Tensor:
    """K2: (F,) f32 column sums of (x - am)^2."""
    d = x.float() - am
    return (d * d).sum(0)


def affine_reference(x: torch.Tensor, g: torch.Tensor,
                     h: torch.Tensor) -> torch.Tensor:
    """K3: x*g + h in f32, rounded once to x's dtype."""
    return (x.float() * g + h).to(x.dtype)


def bwd_reduce_reference(dy: torch.Tensor, x: torch.Tensor,
                         am: torch.Tensor) -> tuple:
    """K4: ((F,), (F,)) f32 column sums of dy and of dy*(x - am)."""
    dyf = dy.float()
    return dyf.sum(0), (dyf * (x.float() - am)).sum(0)


def bwd_dx_reference(dy: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                     c2: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """K5: dy*a + x*c2 + c1 in f32, rounded once to x's dtype."""
    return (dy.float() * a + x.float() * c2 + c1).to(x.dtype)


PLAIN = SimpleNamespace(colsum=colsum_reference, varsum=varsum_reference,
                        affine=affine_reference,
                        bwd_reduce=bwd_reduce_reference,
                        bwd_dx=bwd_dx_reference)


# ------------------------------------------------------------------ kernels


def rows_per_cta(n: int) -> int:
    """Rows each CTA owns: at least 64, and at most 512 CTAs (partials)
    down the rows, so the finish pass stays small."""
    return max(64, -(-n // 512))


_LIB: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    """The built library, its two entry points typed once: these passes
    are short, so the host's per-call cost shows beside them."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from glass_tpu_torch.ops import _build

    lib = _build.load("graph_norm")
    red = lib.glass_norm_reduce
    red.restype = ctypes.c_int
    red.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p])
    row = lib.glass_norm_rowwise
    row.restype = ctypes.c_int
    row.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 4
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p])
    _LIB = lib
    return lib


def _check(name: str, x: torch.Tensor, others=(), vecs=()) -> None:
    """The rules every pass holds its operands to: (N, F) x of f32 or
    bf16, other (N, F) operands of x's dtype, (F,) f32 vectors, one device,
    contiguous."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (N, F), got {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16 x, not {x.dtype}")
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} "
                             f"does not match x {tuple(x.shape)} {x.dtype}")
    for v in vecs:
        if v.shape != (x.shape[1],) or v.dtype != torch.float32:
            raise ValueError(f"{name}: per-feature vectors are ({x.shape[1]},) "
                             f"float32, got {tuple(v.shape)} {v.dtype}")
    if any(t.device != x.device for t in (*others, *vecs)):
        raise ValueError(f"{name}: operands lie on several devices")
    if not all(t.is_contiguous() for t in (x, *others, *vecs)):
        raise ValueError(f"{name} takes contiguous tensors")


def _count(kernel: str, x: torch.Tensor) -> None:
    fused_graph_norm.launches += LAUNCHES_PER_PASS[kernel]
    for by, key in ((fused_graph_norm.launches_by_kernel, kernel),
                    (fused_graph_norm.launches_by_dtype,
                     str(x.dtype).removeprefix("torch."))):
        by[key] = by.get(key, 0) + 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _reduce(kernel: str, mode: int, x: torch.Tensor,
            dy: Optional[torch.Tensor], am: Optional[torch.Tensor],
            n_out: int) -> torch.Tensor:
    """(n_out, F) f32 column sums through the kernel's two launches."""
    n, f = x.shape
    if n == 0 or f == 0:
        return torch.zeros((n_out, f), dtype=torch.float32, device=x.device)
    out = torch.empty((n_out, f), dtype=torch.float32, device=x.device)
    rows = rows_per_cta(n)
    partial = torch.empty((n_out, -(-n // rows), f), dtype=torch.float32,
                          device=x.device)
    lib = _kernel()
    with torch.cuda.device(x.device):
        rc = lib.glass_norm_reduce(
            mode, x.data_ptr(), _ptr(dy), DTYPE_CODES[x.dtype], _ptr(am),
            partial.data_ptr(), out.data_ptr(), n, f, rows,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"graph_norm {kernel} launch failed: CUDA error {rc}")
    _count(kernel, x)
    return out


def _rowwise(kernel: str, mode: int, x: torch.Tensor,
             dy: Optional[torch.Tensor], vecs: tuple) -> torch.Tensor:
    """(N, F) of x's dtype through the kernel's one launch."""
    n, f = x.shape
    out = torch.empty_like(x)
    if n == 0 or f == 0:
        return out
    v0, v1, v2 = (*vecs, None)[:3]
    lib = _kernel()
    with torch.cuda.device(x.device):
        rc = lib.glass_norm_rowwise(
            mode, x.data_ptr(), _ptr(dy), DTYPE_CODES[x.dtype], v0.data_ptr(),
            v1.data_ptr(), _ptr(v2), out.data_ptr(), n, f, rows_per_cta(n),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"graph_norm {kernel} launch failed: CUDA error {rc}")
    _count(kernel, x)
    return out


def _on_card(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU tensor (the
    plain version); raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on 'cuda' or 'cpu', not {x.device}")
    return True


def colsum(x: torch.Tensor) -> torch.Tensor:
    """K1 (``_colsum_kernel``): (F,) f32 column sums of x."""
    _check("colsum", x)
    if not _on_card("colsum", x):
        return colsum_reference(x)
    return _reduce("colsum", _RED_SUM, x, None, None, 1)[0]


def varsum(x: torch.Tensor, am: torch.Tensor) -> torch.Tensor:
    """K2 (``_varsum_kernel``): (F,) f32 column sums of (x - am)^2."""
    _check("varsum", x, vecs=(am,))
    if not _on_card("varsum", x):
        return varsum_reference(x, am)
    return _reduce("varsum", _RED_VAR, x, None, am, 1)[0]


def affine(x: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """K3 (``_affine_kernel``): x*g + h in x's dtype."""
    _check("affine", x, vecs=(g, h))
    if not _on_card("affine", x):
        return affine_reference(x, g, h)
    return _rowwise("affine", _EW_AFFINE, x, None, (g, h))


def bwd_reduce(dy: torch.Tensor, x: torch.Tensor, am: torch.Tensor) -> tuple:
    """K4 (``_bwd_reduce_kernel``): (R1, R2), (F,) f32 each."""
    _check("bwd_reduce", x, others=(dy,), vecs=(am,))
    if not _on_card("bwd_reduce", x):
        return bwd_reduce_reference(dy, x, am)
    r = _reduce("bwd_reduce", _RED_BWD, x, dy, am, 2)
    return r[0], r[1]


def bwd_dx(dy: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
           c2: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """K5 (``_bwd_dx_kernel``): dy*a + x*c2 + c1 in x's dtype."""
    _check("bwd_dx", x, others=(dy,), vecs=(a, c2, c1))
    if not _on_card("bwd_dx", x):
        return bwd_dx_reference(dy, x, a, c2, c1)
    return _rowwise("bwd_dx", _EW_DX, x, dy, (a, c2, c1))


KERNEL = SimpleNamespace(colsum=colsum, varsum=varsum, affine=affine,
                         bwd_reduce=bwd_reduce, bwd_dx=bwd_dx)


# ----------------------------------------------------------------- autograd


class _FusedGraphNorm(torch.autograd.Function):
    """``pallas_norm.py``'s custom VJP: ``_fwd`` and ``_bwd`` with the
    passes of ``passes`` (KERNEL or PLAIN)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean_scale, eps, passes):
        n = x.shape[0]
        mu = passes.colsum(x) / n
        am = (mean_scale * mu).contiguous()
        var = passes.varsum(x, am) / n
        s = torch.rsqrt(var + eps)
        g = weight * s
        hv = bias - g * mean_scale * mu
        y = passes.affine(x, g.contiguous(), hv.contiguous())
        ctx.save_for_backward(x, mu, var, weight, mean_scale)
        ctx.eps, ctx.passes = eps, passes
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mu, var, weight, mean_scale = ctx.saved_tensors
        passes = ctx.passes
        n = x.shape[0]
        s = torch.rsqrt(var + ctx.eps)
        am = (mean_scale * mu).contiguous()
        dy = dy.to(x.dtype).contiguous()
        r1, r2 = passes.bwd_reduce(dy, x, am)
        mo = mu * (1.0 - mean_scale)  # mean(x - alpha*mu)
        w = weight.float()
        a = w * s
        c2 = -(w * s**3 / n) * r2
        # dx_j = a*dy_j - (w*alpha*s/n)*R1 - (w*s^3/n)*R2*(x_j - alpha*mu - alpha*mo)
        c1 = -(w * mean_scale * s / n) * r1 - c2 * (
            mean_scale * mu + mean_scale * mo)
        dx = passes.bwd_dx(dy, x, a.contiguous(), c2.contiguous(),
                           c1.contiguous())
        dw = (s * r2).to(weight.dtype)
        db = r1.to(weight.dtype)
        dalpha = (-w * mu * s * r1 + w * mu * mo * s**3 * r2).to(weight.dtype)
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

"""Banded-slab adjacency and its SpMM.

Counterpart of the host half and the dispatch of
``glass_tpu/ops/pallas_band.py``. An adjacency whose nonzeros sit in a
diagonal band (a locality-ordered graph) is stored as one dense slab per
group of ``rps`` consecutive 128-row blocks:

    out[g*rps*128 + r, :] = scale[r] * sum_k slabs[g, r, k] * x[clo[g]*128 + k, :]

where ``clo[g]`` is the first column block of group g's window of
``w_blocks`` column blocks and rows of x outside ``[0, n_x)`` read as zero.
An affine layout (``affine_stride`` set) has ``clo[g] == g*stride + off``
exactly, which may be negative at the top and run past ``n_cb`` at the
bottom. Slabs are f32, bf16 or int8; int8 slabs carry a per-row scale (the
bf16-rounded ``amax / 127`` of the row), f32 and bf16 slabs none.

The host half builds the same arrays as the JAX builder. The device half is
:func:`band_spmm`: on a CUDA tensor it launches the hand-written kernel of
``csrc/band_spmm.cu``, which replaces the Pallas bodies
``_band_kernel_affine``, ``_band_kernel_affine_q``, ``_band_kernel``,
``_band_kernel_xvmem``, ``_band_kernel_xvmem_gps``, ``_band_kernel_gps`` and
``_band_kernel_striped`` (f32 slabs on the tensor cores as three TF32
products, bf16 and int8 slabs as bf16 products through a TMA + wgmma
pipeline); on a CPU tensor it runs
:func:`band_spmm_reference`, the kernel's plain PyTorch version. As in the JAX package, x is rounded to bf16
whenever the slabs are bf16 or int8, and the output is f32. Given the
transposed layout, :func:`band_spmm` is differentiable in x: the backward
is the same kernel over ``band_t`` (``pallas_band.py::_make_diff_band_spmm``)
and dx comes back in x's dtype.

The hybrid split's window planner (:func:`plan_windows` and the histograms
behind it) is here too.

Layouts may be rectangular (``n_col`` columns independent of the rows: the
sharded path's local-rows x global-columns layouts and their transposes)
and row-range trimmed (``g_lo`` set): the slabs then hold only row groups
[g_lo, g_lo + n_groups) of ``n_g_total``, and the product's other rows are
zero. The kernel writes the stored groups' rows from row g_lo*rps*128 of
an output allocated zeroed (its ``out_row0`` argument), as
``pallas_band.py:1029-1035`` scatters them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from glass_tpu_torch import native
from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops._common import BLOCK, on_card, spmm_with_transpose

# The reference's layout rule, kept so that rps, the window width and the
# affine gate equal the JAX builder's: pallas_band.py sizes a layout to fit
# the TPU v5e kernel's per-step VMEM working set (a 15.5 MiB budget with
# double-buffered x windows). Neither number is a fact about the H100; their
# refit for it is open (ROADMAP Queue 1 item 6): a new rule would change
# the layouts against the JAX builder's.
NBUF = 2
LAYOUT_BUDGET_BYTES = int(15.5 * 1024 * 1024)

# Slab and x dtypes the kernels take, by the code csrc/*.cu dispatch on.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
X_DTYPES = (torch.float32, torch.bfloat16)
# build_band_arrays' dtype names, as the JAX builders spell them
SLAB_DTYPES = {"float32": torch.float32, "f32": torch.float32,
               "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
               "int8": torch.int8}


@dataclass(frozen=True)
class BandedAdj:
    """Banded-slab adjacency on one device (see the module docstring).

    slabs[g] is the dense (rps*128, w_blocks*128) slab of row-block group g;
    clo[g] the first column block of its window; row_scale[r] the
    dequantization scale of output row r (int8 slabs only)."""

    slabs: torch.Tensor  # (n_g, rps*BLOCK, w_blocks*BLOCK) f32 | bf16 | int8
    clo: torch.Tensor  # (n_g,) int32
    n_rb: int
    n_cb: int
    n_node: int  # real output rows
    rps: int  # row blocks per group
    w_blocks: int  # window width in column blocks
    affine_stride: Optional[int] = None
    affine_off: Optional[int] = None
    # (n_g*rps*BLOCK,) f32 holding bf16 values; the JAX layout keeps them as
    # (n_g, rps*BLOCK, BLOCK) bf16, a lane broadcast for the TPU's tiling
    row_scale: Optional[torch.Tensor] = None
    # row-range trim: the first stored group, or None untrimmed; the
    # layout's total group count (0: n_groups)
    g_lo: Optional[int] = None
    n_g_total: int = 0

    @property
    def n_groups(self) -> int:
        return int(self.slabs.shape[0])

    @property
    def total_groups(self) -> int:
        return self.n_g_total if self.n_g_total else self.n_groups


def _group_minmax(g, v, n_g: int, v_default_lo: int):
    """Per-group (min, max+1) of ``v`` grouped by ``g``; absent groups get
    (v_default_lo, 0). Copy of ``pallas_band.py::_group_minmax``."""
    lo = np.full(n_g, v_default_lo, dtype=np.int64)
    hi = np.zeros(n_g, dtype=np.int64)
    if g.size == 0:
        return lo, hi
    if np.any(np.diff(g) < 0):
        order = np.argsort(g, kind="stable")
        g, v = g[order], v[order]
    first = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    present = g[first]
    lo[present] = np.minimum.reduceat(v, first)
    hi[present] = np.maximum.reduceat(v, first) + 1
    return lo, hi


def _n_cb(n_node: int, n_col) -> int:
    """Column blocks of a layout with ``n_col`` columns (square: None)."""
    return -(-(n_col if n_col is not None else n_node) // BLOCK)


def rowblock_spans(row, col, n_node: int, n_col=None):
    """Per-row-block column-block (lo, hi+1) spans in one edge pass; every
    rps candidate's group spans are reductions of these. ``n_col``: the
    column count of a rectangular layout (square by default). Copy of
    ``pallas_band.py::rowblock_spans``."""
    row = np.asarray(row)
    col = np.asarray(col)
    return _group_minmax(row // BLOCK, col // BLOCK, -(-n_node // BLOCK),
                         _n_cb(n_node, n_col))


def band_stats(row, col, weight, n_node: int, rps: int, n_col=None,
               rb_span=None):
    """(w_blocks, clo, slab_bytes_f32, n_groups) of the per-group window
    layout: the widest group span sets the width, and each window start is
    clamped so the window lies in bounds. ``rb_span`` (from
    :func:`rowblock_spans`) skips the edge pass. Copy of
    ``pallas_band.py::band_stats``."""
    n_rb = -(-n_node // BLOCK)
    n_cb = _n_cb(n_node, n_col)
    n_g = -(-n_rb // rps)
    if rb_span is not None:
        lo_rb, hi_rb = rb_span
        first = np.arange(0, n_rb, rps)
        lo = np.minimum.reduceat(lo_rb, first)
        hi = np.maximum.reduceat(hi_rb, first)
    else:
        row = np.asarray(row)
        col = np.asarray(col)
        keep = np.asarray(weight) != 0
        row, col = row[keep], col[keep]
        lo, hi = _group_minmax((row // BLOCK) // rps, col // BLOCK, n_g, n_cb)
    width = np.maximum(hi - lo, 1)
    w = int(width.max()) if width.size else 1
    w = min(w, n_cb)
    clo = np.clip(np.minimum(lo, n_cb - w), 0, None).astype(np.int32)
    slab_bytes = n_g * rps * BLOCK * w * BLOCK * 4
    return w, clo, slab_bytes, n_g


def window_starts(row, col, n_node: int, rps: int, w: int, n_col=None):
    """Clamped per-group window starts for a forced width ``w`` (the
    per-shard layouts share one width); raises if a group's column span
    exceeds it. Copy of ``pallas_band.py::window_starts``."""
    row = np.asarray(row)
    col = np.asarray(col)
    n_cb = _n_cb(n_node, n_col)
    n_g = -(-(-(-n_node // BLOCK)) // rps)
    lo, hi = _group_minmax((row // BLOCK) // rps, col // BLOCK, n_g, n_cb)
    if np.any(hi - lo > w):
        raise ValueError(
            f"group span {int((hi - lo).max())} blocks exceeds the forced "
            f"window width {w}")
    return np.clip(np.minimum(lo, n_cb - w), 0, None).astype(np.int32)


def plan_windows(row, col, weight, n_node: int, rps: int, w: int):
    """Per-group best window of fixed width ``w`` blocks: for each row-block
    group, the start whose ``w`` column blocks cover the most edges. Returns
    ``(clo, in_band)``: the (n_g,) int32 window starts and the mask of the
    edges inside their group's window (zero-weight edges never are). The
    hybrid split: the band carries the in-window mass, BCSR the rest. Copy
    of ``pallas_band.py::plan_windows``."""
    row = np.asarray(row)
    col = np.asarray(col)
    keep = np.asarray(weight) != 0
    cs = window_histogram(row, col, keep, n_node, rps)
    clo, _ = best_windows(cs, w)
    g = (row // BLOCK) // rps
    cb = col // BLOCK
    w = min(w, cs.shape[1] - 1)
    in_band = keep & (cb >= clo[g]) & (cb < clo[g] + w)
    return clo, in_band


def block_histogram(row, col, keep, n_node: int, n_col=None):
    """Per-(row-block, column-block) edge counts, (n_rb, n_cb+1) int64 with
    column block b counted at index b+1 (ready for a cumsum). Copy of
    ``pallas_band.py::block_histogram``."""
    n_rb = -(-n_node // BLOCK)
    n_cb = _n_cb(n_node, n_col)
    flat = (row[keep] // BLOCK) * (n_cb + 1) + col[keep] // BLOCK + 1
    return np.bincount(flat, minlength=n_rb * (n_cb + 1)).reshape(
        n_rb, n_cb + 1)


def window_histogram_from_blocks(counts_rb: np.ndarray, rps: int):
    """The (n_g, n_cb+1) cumulative histogram of row-block groups of
    ``rps``, summed from :func:`block_histogram`. Copy of
    ``pallas_band.py::window_histogram_from_blocks``."""
    n_rb = counts_rb.shape[0]
    agg = np.add.reduceat(counts_rb, np.arange(0, n_rb, rps), axis=0)
    return np.cumsum(agg, axis=1)


def window_histogram(row, col, keep, n_node: int, rps: int):
    """Cumulative per-(group, column-block) edge histogram: ``cs[g, b+1] -
    cs[g, a]`` edges of group g in column blocks [a, b]. Copy of
    ``pallas_band.py::window_histogram``."""
    return window_histogram_from_blocks(
        block_histogram(row, col, keep, n_node), rps)


def best_windows(cs, w: int):
    """``(clo, covered)``: the best ``w``-wide window start of each group of
    a :func:`window_histogram` and the edges all of them cover. Copy of
    ``pallas_band.py::best_windows``."""
    n_cb = cs.shape[1] - 1
    w = min(w, n_cb)
    n_start = n_cb - w + 1
    win = cs[:, w: w + n_start] - cs[:, :n_start]
    clo = np.argmax(win, axis=1).astype(np.int32)
    covered = int(win[np.arange(cs.shape[0]), clo].sum())
    return clo, covered


def affine_fit(row, col, weight, n_node: int, rps: int, n_col=None,
               rb_span=None):
    """(stride, off, w_blocks) of the affine window law clo[g] = g*stride +
    off that covers every group's column span, or None for an empty graph.
    The stride is the least-squares slope of the groups' first column
    blocks, snapped to an int >= 0. Copy of ``pallas_band.py::affine_fit``."""
    n_rb = -(-n_node // BLOCK)
    n_cb = _n_cb(n_node, n_col)
    n_g = -(-n_rb // rps)
    if rb_span is not None:
        lo_rb, hi_rb = rb_span
        if not np.any(hi_rb > 0):
            return None
        first = np.arange(0, n_rb, rps)
        lo = np.minimum.reduceat(lo_rb, first)
        hi = np.maximum.reduceat(hi_rb, first)
    else:
        row = np.asarray(row)
        col = np.asarray(col)
        keep = np.asarray(weight) != 0
        row, col = row[keep], col[keep]
        if row.size == 0:
            return None
        lo, hi = _group_minmax((row // BLOCK) // rps, col // BLOCK, n_g, n_cb)
    g = np.flatnonzero(hi > 0)
    if g.size == 1:
        stride = 0
    else:
        gm = g - g.mean()
        stride = int(round(float((gm * (lo[g] - lo[g].mean())).sum()
                                 / max((gm * gm).sum(), 1e-9))))
        stride = max(stride, 0)
    off = int((lo[g] - g * stride).min())
    w = int((hi[g] - g * stride).max()) - off
    return stride, off, w


def affine_clo(n_g: int, stride: int, off: int) -> np.ndarray:
    return (np.arange(n_g, dtype=np.int64) * stride + off).astype(np.int32)


def band_vmem_ok(rps: int, w_blocks: int, h_pad: int, itemsize: int) -> bool:
    """The reference's layout rule (see ``LAYOUT_BUDGET_BYTES``): True if
    the TPU kernel's per-step working set — double-buffered slab, ``NBUF``
    x windows, double-buffered output — fits the budget. Copy of
    ``pallas_band.py::band_vmem_ok``."""
    slab = 2 * rps * BLOCK * w_blocks * BLOCK * itemsize
    xwin = NBUF * w_blocks * BLOCK * h_pad * itemsize
    out = 2 * rps * BLOCK * h_pad * 4
    return slab + xwin + out <= LAYOUT_BUDGET_BYTES


def build_band_arrays(row, col, weight, n_node: int, rps: int = 8,
                      dtype: str = "float32", window=None, n_col=None,
                      trim_groups=None) -> dict:
    """Host-side banded-slab construction from (already normalized) COO
    arrays. Zero-weight edges are ignored and duplicate edges add up
    (accumulated in f64, then rounded to f32). Edges outside ``[0, n_node)
    x [0, n_col)`` raise. ``window``: optional (w_blocks, clo) forcing the
    windows (the affine law, the hybrid split, the per-shard layouts);
    every edge must fall inside its group's window. ``n_col``: the column
    count of a rectangular layout (square by default). ``trim_groups``:
    optional (g_lo, n_g_store), storing only row groups [g_lo, g_lo +
    n_g_store); every edge must fall inside them.

    ``dtype`` "float32", "bfloat16" (the f32 slabs rounded to nearest even)
    or "int8": each slab row quantized symmetrically, ``rint(slab /
    scale)`` with ``scale = amax/127`` (1 for an all-zero row), and the
    scales rounded to bf16 (``pallas_band.py:404-420``).

    Returns slabs (a CPU tensor of ``dtype``: numpy has no bf16),
    row_scale (a CPU f32 tensor of bf16 values, or None), clo (the stored
    groups'), n_rb, n_cb, w_blocks, g_lo (0 untrimmed) and n_g_total,
    equal to those of ``glass_tpu.ops.pallas_band.build_band_arrays``."""
    if dtype not in SLAB_DTYPES:
        raise ValueError(f"unknown band slab dtype {dtype!r}")
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    weight = np.asarray(weight)
    n_cb = _n_cb(n_node, n_col)
    if row.size and (min(row.min(), col.min()) < 0 or row.max() >= n_node
                     or col.max() >= n_cb * BLOCK):
        raise ValueError(f"edge endpoints must lie in [0, {n_node}) x "
                         f"[0, {n_col or n_node})")
    keep = weight != 0
    row, col, weight = row[keep], col[keep], weight[keep]
    n_rb = -(-n_node // BLOCK)
    n_g_total = -(-n_rb // rps)
    g = (row // BLOCK) // rps
    if window is not None:
        w, clo = window
        clo = np.asarray(clo, dtype=np.int32)
        cb = col // BLOCK
        if cb.size and not ((cb >= clo[g]) & (cb < clo[g] + w)).all():
            raise ValueError("edge outside its forced band window")
    else:
        w, clo, _, _ = band_stats(row, col, np.ones_like(row), n_node, rps,
                                  n_col=n_col)
    if clo.shape[0] != n_g_total:
        raise ValueError(f"window table has {clo.shape[0]} groups, expected "
                         f"{n_g_total}")
    g_lo, n_g = 0, n_g_total
    if trim_groups is not None:
        g_lo, n_g = trim_groups
        if not 0 <= g_lo <= n_g_total - n_g:
            raise ValueError(f"trim range [{g_lo}, {g_lo + n_g}) outside the "
                             f"{n_g_total}-group layout")
        if g.size and not ((g >= g_lo) & (g < g_lo + n_g)).all():
            raise ValueError("edge outside the trimmed group range")
        # shift the rows so that the fill sees groups [0, n_g)
        row = row - g_lo * (rps * BLOCK)
        g = g - g_lo
        clo = clo[g_lo: g_lo + n_g]
    slabs = native.band_fill(row, col, weight, rps, w, clo, n_g)
    if slabs is None:
        # flat bincount: the same f64 sums in edge order
        lr = row - g * (rps * BLOCK)
        lc = col - clo[g].astype(np.int64) * BLOCK
        flat = (g * (rps * BLOCK) + lr) * (w * BLOCK) + lc
        slabs = np.bincount(flat, weights=weight,
                            minlength=n_g * rps * BLOCK * w * BLOCK).reshape(
            n_g, rps * BLOCK, w * BLOCK).astype(np.float32)
    slabs, row_scale = _to_slab_dtype(slabs, SLAB_DTYPES[dtype])
    return dict(slabs=slabs, row_scale=row_scale, clo=clo, n_rb=n_rb,
                n_cb=n_cb, w_blocks=int(w), g_lo=int(g_lo),
                n_g_total=n_g_total)


def _to_slab_dtype(slabs: np.ndarray, dtype: torch.dtype):
    """(slabs as a tensor of ``dtype``, per-row scale or None) from f32 host
    slabs of shape (..., rows, k): the JAX builder's casts, with int8
    quantized per row (the last axis)."""
    if dtype == torch.int8:
        amax = np.abs(slabs).max(axis=-1, keepdims=True)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = torch.from_numpy(np.rint(slabs / scale).astype(np.int8))
        return q, torch.from_numpy(scale.reshape(-1)).to(
            torch.bfloat16).to(torch.float32)
    return torch.from_numpy(slabs).to(dtype), None


def build_band(row, col, weight, n_node: int, rps: int = 8, *,
               affine=None, device="cpu", **kw) -> BandedAdj:
    """:func:`build_band_arrays`, placed on ``device``. ``affine``: optional
    (stride, off, w_blocks) from :func:`affine_fit`, which forces the affine
    window law and marks the layout affine."""
    stride = off = None
    if affine is not None:
        stride, off, w_aff = affine
        n_rb = -(-n_node // BLOCK)
        kw["window"] = (w_aff, affine_clo(-(-n_rb // rps), stride, off))
    a = build_band_arrays(row, col, weight, n_node, rps, **kw)
    return band_from_arrays(a, n_node, rps, device, affine=(stride, off),
                            trimmed=kw.get("trim_groups") is not None)


def band_from_arrays(a: dict, n_node: int, rps: int, device="cpu",
                     affine=(None, None), trimmed: bool = False) -> BandedAdj:
    """The :class:`BandedAdj` of a :func:`build_band_arrays` dict on
    ``device``, with ``n_node`` real output rows; ``trimmed`` keeps its
    ``g_lo``."""
    return BandedAdj(
        slabs=a["slabs"].to(device),
        clo=torch.as_tensor(a["clo"]).to(device),
        n_rb=a["n_rb"], n_cb=a["n_cb"], n_node=int(n_node), rps=int(rps),
        w_blocks=a["w_blocks"], affine_stride=affine[0],
        affine_off=affine[1],
        row_scale=(None if a["row_scale"] is None
                   else a["row_scale"].to(device)),
        g_lo=int(a["g_lo"]) if trimmed else None,
        n_g_total=int(a["n_g_total"]))


def check_operands(name: str, slabs: torch.Tensor, row_scale, x, others=()):
    """The dtype, device, contiguity and gradient rules every kernel of
    ``csrc/`` holds its operands to; ``others`` are the layout's index
    tables. Raises with ``name`` in the message."""
    if x.dim() != 2:
        raise ValueError(f"x must be (n, H), got shape {tuple(x.shape)}")
    if x.dtype not in X_DTYPES or slabs.dtype not in DTYPE_CODES:
        raise TypeError(
            f"{name} takes float32, bfloat16 or int8 slabs and float32 or "
            f"bfloat16 x, got {slabs.dtype} and {x.dtype}")
    if (row_scale is not None) != (slabs.dtype == torch.int8):
        raise TypeError(f"{name}: int8 slabs and only they carry a row scale")
    if row_scale is not None and row_scale.dtype != torch.float32:
        raise TypeError(f"{name}: the row scale must be float32")
    if slabs.requires_grad:
        raise RuntimeError(
            f"{name}'s autograd rule gives no gradient for the layout: its "
            "slabs must not require grad")
    tensors = (slabs, x, *others) + (() if row_scale is None else (row_scale,))
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"the {name} layout and x must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _check(band: BandedAdj, x: torch.Tensor) -> None:
    check_operands("band_spmm", band.slabs, band.row_scale, x, (band.clo,))
    if x.shape[0] > band.n_cb * BLOCK:
        raise ValueError(
            f"x has {x.shape[0]} rows; the layout's columns span "
            f"{band.n_cb * BLOCK}")
    if band.clo.dtype != torch.int32:
        raise TypeError("clo must be int32")
    if band.row_scale is not None and \
            band.row_scale.shape != (band.n_groups * band.rps * BLOCK,):
        raise ValueError(f"row_scale of shape {tuple(band.row_scale.shape)} "
                         "does not hold one value per slab row")


def x_operand(slab_dtype: torch.dtype, x: torch.Tensor) -> torch.Tensor:
    """x as slabs of ``slab_dtype`` multiply it, in f32: rounded to bf16
    for bf16 and int8 slabs (``pallas_band.py:870-871``), exactly widened
    for f32 slabs."""
    if slab_dtype != torch.float32:
        x = x.to(torch.bfloat16)
    return x.float()


def mma_x_operand(x: torch.Tensor):
    """x as the bf16 and int8 layouts' kernels read it, ``(xb, ld)``: x
    rounded to bf16 once (to nearest even, :func:`x_operand`'s rounding),
    row-major, its rows padded with zero columns to ``ld``, a multiple of 8
    values (the 16-byte row stride a tensor map needs), and 16-byte aligned.
    bf16 x of such a width is used as it is."""
    h = x.shape[1]
    ld = -(-h // 8) * 8
    if ld == h:
        xb = x.to(torch.bfloat16)
    else:
        xb = x.new_zeros((x.shape[0], ld), dtype=torch.bfloat16)
        xb[:, :h] = x
    if xb.data_ptr() % 16:
        xb = xb.clone()
    return xb, ld


def band_spmm_reference(band: BandedAdj, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: gathers each
    group's x window (rows outside [0, n_x) as zeros), multiplies it with
    the group's slab widened to f32 (``torch.bmm``; every product is exact,
    as on the MXU), stacks the groups' rows and scales them; a trimmed
    layout's rows go in at group g_lo of a zero output. Returns (n_node, H)
    f32."""
    _check(band, x)
    x = x_operand(band.slabs.dtype, x)
    n_x, h = x.shape
    k = band.w_blocks * BLOCK
    idx = (band.clo.long()[:, None] * BLOCK
           + torch.arange(k, device=x.device)[None, :])
    inside = (idx >= 0) & (idx < n_x)
    if n_x == 0:
        xw = x.new_zeros((band.n_groups, k, h))
    else:
        xw = torch.where(inside[..., None], x[idx.clamp(0, n_x - 1)], 0.0)
    out = torch.bmm(band.slabs.float(), xw).reshape(-1, h)
    if band.row_scale is not None:
        out = out * band.row_scale[:, None]
    if band.g_lo is not None:  # trimmed: the stored groups' rows in place
        full = out.new_zeros((band.total_groups * band.rps * BLOCK, h))
        r0 = band.g_lo * band.rps * BLOCK
        full[r0: r0 + out.shape[0]] = out
        out = full
    return out[: band.n_node]


def _launch(band: BandedAdj, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x through the kernel (CUDA) or the plain version (CPU).
    On a card, one call of ``csrc/band_spmm.cu`` on checked operands: the
    (n_node, H) f32 product (a trimmed layout's rows from g_lo*rps*128 of a
    zeroed output, the kernel's ``out_row0``). f32 slabs run 3xTF32 on the
    tensor cores; bf16 and int8 slabs run bf16 products (wgmma) on x
    rounded to bf16 once here (:func:`mma_x_operand`; see the source)."""
    if not on_card("band_spmm", x):
        return band_spmm_reference(band, x)
    h = x.shape[1]
    # a trimmed layout writes only its stored groups' rows: the rest are
    # zeros from the allocation
    alloc = torch.empty if band.g_lo is None else torch.zeros
    out = alloc((band.n_node, h), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if x.shape[0] == 0:  # every row of x reads as zero
        return out.zero_()
    if band.slabs.data_ptr() % 16:
        raise ValueError("the kernel reads slabs in 16-byte loads: their "
                         "storage must be 16-byte aligned")
    ld = h
    if band.slabs.dtype != torch.float32:
        x, ld = mma_x_operand(x)
    index = x.get_device()
    _build.launch(
        "band_spmm", _build.load("band_spmm").glass_band_spmm, index,
        band.slabs.data_ptr(), DTYPE_CODES[band.slabs.dtype],
        band.clo.data_ptr(),
        None if band.row_scale is None else band.row_scale.data_ptr(),
        x.data_ptr(), DTYPE_CODES[x.dtype], ld, out.data_ptr(),
        band.n_groups, band.rps, band.w_blocks, x.shape[0], band.n_node,
        (band.g_lo or 0) * band.rps * BLOCK, h,
        torch._C._cuda_getCurrentRawStream(index))
    band_spmm.launches += 1
    dt = str(band.slabs.dtype).removeprefix("torch.")
    band_spmm.launches_by_dtype[dt] = band_spmm.launches_by_dtype.get(dt, 0) + 1
    return out


def band_spmm(band: BandedAdj, x: torch.Tensor,
              band_t: Optional[BandedAdj] = None) -> torch.Tensor:
    """out = A @ x with A in banded-slab form. x: (n, H) f32 or bf16 with
    n <= n_cb*128; returns (n_node, H) f32.

    A CUDA tensor goes to the hand-written kernel (``csrc/band_spmm.cu``,
    built at first use) or raises; a CPU tensor goes to
    :func:`band_spmm_reference`. With ``band_t``, the layout of A^T (the
    same object when A is symmetric), the product is differentiable in x
    and the backward runs the same kernel over ``band_t``, dx in x's dtype;
    without it, x must not need a gradient. ``band_spmm.launches`` counts
    kernel launches, forward and backward, and
    ``band_spmm.launches_by_dtype`` splits the count by slab dtype
    ("float32", "bfloat16", "int8")."""
    _check(band, x)
    return spmm_with_transpose(_launch, band, x, band_t, "band_spmm")


band_spmm.launches = 0
band_spmm.launches_by_dtype = {}

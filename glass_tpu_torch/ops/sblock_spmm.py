"""Sparse-block adjacency (SBlock) and its SpMM: stored 128x128 blocks that
list their nonzeros instead of holding them dense.

A layout of the port's own (the JAX package has none like it). Where BCSR
(``ops/bcsr_spmm.py``) stores each live block as 128 x 128 values, this one
stores its nonzeros, sorted by local row, then local column: a ``uint8``
local row, a ``uint8`` local column and an f32 value, 6 bytes a nonzero,
with the same block tables (``block_col``, ``block_row_ptr``, live blocks
only and no CHUNK padding), ``nz_ptr`` (each block's run of nonzeros), a
table of each block's row offsets (``row_off``), which the kernel walks in
place of the local rows, and the kernel's work list (``stages``: each
block's nonzeros in runs of at most STAGE_NNZ, row block by row block,
``stage_ptr``). At the hpo stand-in (every block live at 3 %
fill) that is 38.9 MB of nonzeros where BCSR stores 852 MB.

The host half builds it from an edge list (build_graph's row-sorted int32
edges take one stable sort by block; duplicates add up in f64, then round to
f32, as in BCSR; zero-weight edges are dropped). The device half is
:func:`sblock_spmm`: on a CUDA tensor it launches the hand-written kernel of
``csrc/sblock_spmm.cu``, whose work and bytes follow the nonzeros; on a CPU
tensor it runs :func:`sblock_spmm_reference`, the kernel's plain PyTorch
version. Values are f32 and x f32 or bf16 (widened exactly); the output is
f32. Given the transposed layout (the same object when A is symmetric),
:func:`sblock_spmm` is differentiable in x: the backward is the same kernel
over ``sblock_t``, dx in x's dtype (``_common.spmm_with_transpose``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from glass_tpu_torch.ops import band_spmm as bd
from glass_tpu_torch.ops._common import BLOCK, spmm_with_transpose
from glass_tpu_torch.ops.bcsr_spmm import _row_col_sorted

ROW_LD = 136  # int16 row offsets stored a block: 129 used, 16-byte rows
STAGE_NNZ = 2048  # nonzeros a kernel stage holds (csrc/sblock_spmm.cu MCAP)
# bytes the planner's memory cap counts: a nonzero's row, column and value;
# a block's row offsets and column
NNZ_BYTES = 6
BLOCK_BYTES = 2 * ROW_LD + 4 + 16


@dataclass(frozen=True)
class SBlock:
    """Sparse-block adjacency on one device.

    Block b (layout order: row block by row block, column blocks ascending)
    has column block ``block_col[b]`` and holds nonzeros
    ``nz_ptr[b] .. nz_ptr[b+1]``, sorted by local row (``row``), then local
    column (``col``), with values ``val``; its local row r's nonzeros start
    at ``nz_ptr[b] + row_off[b, r]`` (``row_off[b, 128]`` is its count).
    Row block rb owns blocks ``block_row_ptr[rb] .. block_row_ptr[rb+1]``,
    each holding at least one nonzero, and the kernel's stages
    ``stage_ptr[rb] .. stage_ptr[rb+1]``: ``stages[s]`` is (first nonzero,
    block, column block, offset of the first nonzero in its block << 16 |
    count), each block's nonzeros in runs of at most STAGE_NNZ."""

    val: torch.Tensor  # (nnz,) f32
    row: torch.Tensor  # (nnz,) uint8
    col: torch.Tensor  # (nnz,) uint8
    row_off: torch.Tensor  # (n_blocks, ROW_LD) int16
    block_col: torch.Tensor  # (n_blocks,) int32
    block_row_ptr: torch.Tensor  # (n_rb + 1,) int32
    nz_ptr: torch.Tensor  # (n_blocks + 1,) int32
    stages: torch.Tensor  # (n_stages, 4) int32
    stage_ptr: torch.Tensor  # (n_rb + 1,) int32
    n_rb: int
    n_cb: int
    n_node: int

    @property
    def live_blocks(self) -> int:
        return int(self.block_col.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])


def build_sblock_arrays(row, col, weight, n_node: int,
                        n_col: Optional[int] = None) -> dict:
    """The numpy arrays of an :class:`SBlock` of the (already normalized)
    COO edges, and n_rb, n_cb. Edges sorted by (row, col) (build_graph's)
    are grouped by block with one stable sort; any other order is sorted by
    (row, col) first. Both give the same arrays."""
    n_col = n_node if n_col is None else n_col
    row, col, weight = np.asarray(row), np.asarray(col), np.asarray(weight)
    if row.size and (min(row.min(), col.min()) < 0 or row.max() >= n_node
                     or col.max() >= n_col):
        raise ValueError(f"edge endpoints must lie in [0, {n_node}) x "
                         f"[0, {n_col})")
    n_rb = -(-n_node // BLOCK)
    n_cb = -(-n_col // BLOCK)
    keep = weight != 0
    if not keep.all():
        row, col, weight = row[keep], col[keep], weight[keep]
    del keep
    if not _row_col_sorted(row, col):
        order = np.lexsort((col, row))
        row, col, weight = row[order], col[order], weight[order]
    bid = (row.astype(np.int64) // BLOCK) * n_cb + col // BLOCK
    order = np.argsort(bid, kind="stable")
    row, col, bid = row[order], col[order], bid[order]
    w = weight[order].astype(np.float64)
    del order
    # duplicate edges are adjacent now: their weights add up
    first = np.r_[True, (row[1:] != row[:-1]) | (col[1:] != col[:-1])]
    if not first.all():
        start = np.flatnonzero(first)
        w = np.add.reduceat(w, start)
        row, col, bid = row[start], col[start], bid[start]
    del first
    nnz = row.shape[0]
    new_block = np.r_[True, bid[1:] != bid[:-1]] if nnz else \
        np.zeros(0, bool)
    starts = np.flatnonzero(new_block)
    ubid = bid[starts]
    n_blocks = starts.shape[0]
    block_of = np.cumsum(new_block) - 1
    lrow = (row % BLOCK).astype(np.uint8)
    per_row = np.bincount(block_of * BLOCK + lrow,
                          minlength=n_blocks * BLOCK).reshape(n_blocks, BLOCK)
    row_off = np.zeros((n_blocks, ROW_LD), np.int16)
    row_off[:, 1:BLOCK + 1] = np.cumsum(per_row, axis=1)
    row_off[:, BLOCK + 1:] = row_off[:, BLOCK:BLOCK + 1]
    block_row_ptr = np.searchsorted(ubid // n_cb, np.arange(n_rb + 1))
    nz_ptr = np.r_[starts, nnz]
    # the kernel's stages: each block's nonzeros in runs of STAGE_NNZ
    count = np.diff(nz_ptr)
    runs = -(-count // STAGE_NNZ)
    blk = np.repeat(np.arange(n_blocks), runs)
    first_run = np.cumsum(runs) - runs
    off = (np.arange(blk.shape[0]) - np.repeat(first_run, runs)) * STAGE_NNZ
    stages = np.stack([nz_ptr[:-1][blk] + off, blk, ubid[blk] % n_cb,
                       (off << 16) | np.minimum(count[blk] - off, STAGE_NNZ)],
                      axis=1)
    stage_ptr = np.r_[0, np.cumsum(runs)][block_row_ptr]
    return dict(
        val=w.astype(np.float32),
        row=lrow,
        col=(col % BLOCK).astype(np.uint8),
        row_off=row_off,
        block_col=(ubid % n_cb).astype(np.int32),
        block_row_ptr=block_row_ptr.astype(np.int32),
        nz_ptr=nz_ptr.astype(np.int32),
        stages=stages.astype(np.int32).reshape(-1, 4),
        stage_ptr=stage_ptr.astype(np.int32),
        n_rb=n_rb,
        n_cb=n_cb,
    )


def _padded(a: np.ndarray, device) -> torch.Tensor:
    """``a`` on ``device``, its storage padded with zeros to whole 16-byte
    pieces: the kernel copies a stage's values and columns in such pieces,
    the last one past the array's end."""
    n = a.shape[0]
    per = 16 // a.itemsize
    buf = torch.zeros(-(-n // per) * per, dtype=torch.from_numpy(a[:0]).dtype,
                      device=device)
    buf[:n] = torch.from_numpy(a)
    return buf[:n]


def _whole_pieces(t: torch.Tensor) -> bool:
    """True iff ``t``'s storage runs on to a whole 16-byte piece."""
    end = (t.storage_offset() + t.numel()) * t.element_size()
    return t.untyped_storage().nbytes() >= -(-end // 16) * 16


def build_sblock(row, col, weight, n_node: int, *,
                 n_col: Optional[int] = None, device="cpu") -> SBlock:
    """:func:`build_sblock_arrays`, placed on ``device`` (the values and
    columns in storage padded to whole 16-byte pieces)."""
    a = build_sblock_arrays(row, col, weight, n_node, n_col)
    arrays = {f.name: (_padded(a[f.name], device) if f.name in ("val", "col")
                       else torch.from_numpy(a[f.name]).to(device))
              for f in fields(SBlock)
              if f.name in a and not isinstance(a[f.name], int)}
    return SBlock(**arrays, n_rb=a["n_rb"], n_cb=a["n_cb"],
                  n_node=int(n_node))


def _check(sb: SBlock, x: torch.Tensor) -> None:
    bd.check_operands("sblock_spmm", sb.val, None, x,
                      (sb.row, sb.col, sb.row_off, sb.block_col,
                       sb.block_row_ptr, sb.nz_ptr, sb.stages, sb.stage_ptr))
    if sb.val.dtype != torch.float32:
        raise TypeError("sblock_spmm takes float32 values")
    if x.shape[0] > sb.n_cb * BLOCK:
        raise ValueError(
            f"x has {x.shape[0]} rows; the layout's columns span "
            f"{sb.n_cb * BLOCK}")
    if any(t.dtype != torch.int32 for t in (
            sb.block_col, sb.block_row_ptr, sb.nz_ptr, sb.stages,
            sb.stage_ptr)):
        raise TypeError("block_col, block_row_ptr, nz_ptr, stages and "
                        "stage_ptr must be int32")
    if sb.row.dtype != torch.uint8 or sb.col.dtype != torch.uint8 or \
            sb.row_off.dtype != torch.int16:
        raise TypeError("row and col must be uint8, row_off int16")


def sblock_spmm_reference(sb: SBlock, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: each nonzero's
    global row and column from its block, ``x[col] * val`` added into its
    row (``index_add_``, f32; x widened exactly). Returns (n_node, H) f32."""
    _check(sb, x)
    x = x.float()
    h = x.shape[1]
    dev = x.device
    counts = (sb.nz_ptr[1:] - sb.nz_ptr[:-1]).long()
    rb = torch.repeat_interleave(
        torch.arange(sb.n_rb, device=dev),
        (sb.block_row_ptr[1:] - sb.block_row_ptr[:-1]).long())
    grow = torch.repeat_interleave(rb * BLOCK, counts) + sb.row.long()
    gcol = torch.repeat_interleave(sb.block_col.long() * BLOCK, counts) \
        + sb.col.long()
    x_pad = x.new_zeros((sb.n_cb * BLOCK, h))
    x_pad[: x.shape[0]] = x
    out = x.new_zeros((sb.n_rb * BLOCK, h))
    out.index_add_(0, grow, x_pad.index_select(0, gcol) * sb.val[:, None])
    return out[: sb.n_node]


def _kernel() -> ctypes.CDLL:
    from glass_tpu_torch.ops import _build

    lib = _build.load("sblock_spmm")
    fn = lib.glass_sblock_spmm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def _x_operand(x: torch.Tensor):
    """x as the kernel reads it, ``(x32, ld)``: f32 (bf16 widened exactly),
    row-major with a row stride ``ld`` of a multiple of 4 values, 16-byte
    aligned; an f32 x of such a width is used as it is."""
    h = x.shape[1]
    ld = -(-h // 4) * 4
    if x.dtype == torch.float32 and ld == h and x.data_ptr() % 16 == 0:
        return x, ld
    xp = x.new_zeros((x.shape[0], ld), dtype=torch.float32)
    xp[:, :h] = x
    return xp, ld


def _launch(sb: SBlock, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x through the kernel (CUDA) or the plain version (CPU)."""
    if x.device.type == "cpu":
        return sblock_spmm_reference(sb, x)
    if x.device.type != "cuda":
        raise ValueError(f"sblock_spmm runs on 'cuda' or 'cpu', not "
                         f"{x.device}")
    h = x.shape[1]
    out = torch.empty((sb.n_node, h), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if x.shape[0] == 0 or sb.nnz == 0:  # every product reads as zero
        return out.zero_()
    if any(t.data_ptr() % 16 for t in (sb.val, sb.col, sb.row_off,
                                       sb.stages)) or \
            not (_whole_pieces(sb.val) and _whole_pieces(sb.col)):
        raise ValueError("the kernel reads the layout in 16-byte copies: its "
                         "storage must be 16-byte aligned, and its values' "
                         "and columns' padded to whole pieces "
                         "(build_sblock's)")
    xk, ld = _x_operand(x)
    lib = _kernel()
    with torch.cuda.device(x.device):
        rc = lib.glass_sblock_spmm(
            sb.val.data_ptr(), sb.col.data_ptr(), sb.row_off.data_ptr(),
            sb.stages.data_ptr(), sb.stage_ptr.data_ptr(), xk.data_ptr(), ld,
            out.data_ptr(), xk.shape[0], sb.n_node, h,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sblock_spmm kernel launch failed: CUDA error {rc}")
    sblock_spmm.launches += 1
    return out


def sblock_spmm(sb: SBlock, x: torch.Tensor,
                sb_t: Optional[SBlock] = None) -> torch.Tensor:
    """out = A @ x with A in SBlock form. x: (n, H) f32 or bf16 with
    n <= n_cb*128; returns (n_node, H) f32.

    A CUDA tensor goes to the hand-written kernel (``csrc/sblock_spmm.cu``,
    built at first use) or raises; a CPU tensor goes to
    :func:`sblock_spmm_reference`. With ``sb_t``, the layout of A^T (the
    same object when A is symmetric), the product is differentiable in x
    and the backward runs the same kernel over ``sb_t``, dx in x's dtype;
    without it, x must not need a gradient. ``sblock_spmm.launches`` counts
    kernel launches, forward and backward."""
    _check(sb, x)
    return spmm_with_transpose(_launch, sb, x, sb_t, "sblock_spmm")


sblock_spmm.launches = 0

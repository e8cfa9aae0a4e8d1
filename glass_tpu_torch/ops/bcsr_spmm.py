"""Chunked block-sparse (BCSR) adjacency and its SpMM.

Counterpart of ``glass_tpu/ops/pallas_spmm.py``. The host half builds the
same arrays as the JAX builder: the nonzero 128x128 blocks of the
normalized adjacency, each row block's run padded with zero blocks to a
multiple of ``CHUNK`` and stored as ``(n_store, 128, CHUNK*128)`` wide
chunks, with ``block_col``, ``block_row_ptr`` and the chunk tables, and
one table of its own, ``block_row_end``: where each row block's nonzero
blocks end and its CHUNK padding starts. The device half is
:func:`bcsr_spmm`: on a CUDA tensor it launches the hand-written kernel of
``csrc/bcsr_spmm.cu``, which replaces the two Pallas kernels
``_bcsr_chunk_kernel`` and ``_bcsr_chunk_kernel_large`` and reads the live
blocks only; on a CPU
tensor it runs :func:`bcsr_spmm_reference`, the kernel's plain PyTorch
version. Blocks are f32, bf16 or int8; int8 blocks carry a per-row f32
scale, which the kernel applies to the f32 sum. As in the JAX package, x is
rounded to bf16 whenever the blocks are bf16 or int8, and the output is
f32. Given the transposed layout, :func:`bcsr_spmm` is differentiable in x:
the backward is the same kernel over ``bcsr_t``
(``pallas_spmm.py::_make_diff_bcsr_spmm``), dx in x's dtype.

Not ported: the rectangular (sharded) layouts, ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from glass_tpu_torch.ops import band_spmm as bd
from glass_tpu_torch.ops._common import BLOCK, spmm_with_transpose

CHUNK = 8  # adjacency blocks per stored wide chunk


@dataclass(frozen=True)
class BCSR:
    """Block-sparse adjacency on one device.

    blocks[s] holds stored blocks s*CHUNK .. s*CHUNK+CHUNK-1 side by side;
    block_col[k] is stored block k's column block (0 on padding);
    block_row_ptr[rb] .. block_row_ptr[rb+1] is row block rb's block range,
    whose nonzero blocks come first and end at block_row_end[rb] (the rest
    is CHUNK padding; the kernel skips it).
    Chunk c covers blocks [chunk_start[c], chunk_start[c] + CHUNK) of row
    chunk_row[c]; chunk_len[c] is CHUNK, or 0 for the placeholder chunk of an
    empty row block; chunk_first/chunk_last flag each row's first/last
    chunk."""

    blocks: torch.Tensor  # (n_store, BLOCK, CHUNK*BLOCK) f32 | bf16 | int8
    block_col: torch.Tensor  # (n_store*CHUNK,) int32
    block_row_ptr: torch.Tensor  # (n_rb + 1,) int32
    block_row_end: torch.Tensor  # (n_rb,) int32
    chunk_start: torch.Tensor  # (n_chunks,) int32
    chunk_len: torch.Tensor  # (n_chunks,) int32
    chunk_row: torch.Tensor  # (n_chunks,) int32
    chunk_first: torch.Tensor  # (n_chunks,) int32
    chunk_last: torch.Tensor  # (n_chunks,) int32
    n_rb: int
    n_cb: int
    n_node: int
    row_scale: Optional[torch.Tensor] = None  # (n_rb*BLOCK,) f32, int8 only

    @property
    def nnz_blocks(self) -> int:
        """Stored block count (includes per-row CHUNK-alignment padding)."""
        return int(self.blocks.shape[0]) * CHUNK

    @property
    def live_blocks(self) -> int:
        """Stored blocks the kernel reads: each row block's nonzero run."""
        return int((self.block_row_end - self.block_row_ptr[:-1]).sum())

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_start.shape[0])


def _build_chunks(ptr: np.ndarray, n_rb: int):
    """Splits each row-block's block range into chunks of <= CHUNK blocks."""
    starts, lens, rows, firsts, lasts = [], [], [], [], []
    for rb in range(n_rb):
        lo, hi = int(ptr[rb]), int(ptr[rb + 1])
        if hi == lo:
            starts.append(0)
            lens.append(0)
            rows.append(rb)
            firsts.append(1)
            lasts.append(1)
            continue
        first = 1
        for s in range(lo, hi, CHUNK):
            starts.append(s)
            lens.append(min(CHUNK, hi - s))
            rows.append(rb)
            firsts.append(first)
            lasts.append(1 if s + CHUNK >= hi else 0)
            first = 0
    return (
        np.asarray(starts, np.int32),
        np.asarray(lens, np.int32),
        np.asarray(rows, np.int32),
        np.asarray(firsts, np.int32),
        np.asarray(lasts, np.int32),
    )


def build_bcsr_arrays(row, col, weight, n_node: int,
                      dtype: str = "float32") -> dict:
    """Host-side BCSR construction from (already normalized) COO arrays;
    zero-weight edges are ignored and duplicate edges add up (accumulated in
    f64, then rounded to f32). ``dtype`` "float32", "bfloat16" or "int8":
    int8 quantizes each row of the accumulated blocks by its row's
    ``max|A[r, :]| / 127`` (1 for an empty row), rounds to nearest even and
    clips to +-127 (``pallas_spmm.py:219-243``).

    Returns blocks (a CPU tensor of ``dtype``: numpy has no bf16),
    row_scale ((n_rb*128,) f32 numpy for int8, else None), the numpy index
    tables (block_col, block_row_ptr, chunk_start/len/row/first/last) and
    n_rb, n_cb, equal to those of
    ``glass_tpu.ops.pallas_spmm.build_bcsr_arrays`` for a square layout;
    and the port's skip table block_row_end ((n_rb,) int32,
    ``block_row_ptr[:-1]`` plus each row block's count of nonzero blocks)."""
    if dtype not in bd.SLAB_DTYPES:
        raise ValueError(f"unknown BCSR block dtype {dtype!r}")
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    weight = np.asarray(weight)
    if row.size and (min(row.min(), col.min()) < 0
                     or max(row.max(), col.max()) >= n_node):
        raise ValueError(f"edge endpoints must lie in [0, {n_node})")
    keep = weight != 0
    row, col, weight = row[keep], col[keep], weight[keep]
    n_rb = -(-n_node // BLOCK)
    n_cb = n_rb
    bid = (row // BLOCK) * n_cb + col // BLOCK
    order = np.argsort(bid, kind="stable")
    row, col, weight, bid = row[order], col[order], weight[order], bid[order]
    uniq, start = np.unique(bid, return_index=True)
    ends = np.append(start[1:], bid.shape[0])

    # Per-row CHUNK alignment: each row block's run is padded with zero
    # blocks (column 0) to a multiple of CHUNK, so every chunk is full and
    # lies within one row.
    urows = uniq // n_cb
    counts = np.bincount(urows, minlength=n_rb)
    padded_counts = -(-counts // CHUNK) * CHUNK  # 0 stays 0
    # >= CHUNK so an all-empty graph still stores one (zero) chunk
    nnz_b = max(int(padded_counts.sum()), CHUNK)
    ptr = np.zeros(n_rb + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(padded_counts).astype(np.int32)
    # destination slot of each real block: row's padded base + rank in row
    rank = np.arange(uniq.shape[0]) - np.concatenate(
        ([0], np.cumsum(counts)[:-1])
    )[urows]
    dst = ptr[urows] + rank

    # Wide-chunk storage: stored chunk s is one (BLOCK, CHUNK*BLOCK) matrix
    # holding its CHUNK blocks side by side. Edges are sorted by block, so
    # each edge's slot is its block's dst repeated over the block's run.
    n_store = nnz_b // CHUNK
    e_dst = np.repeat(dst, ends - start)
    flat = (
        (e_dst // CHUNK) * (BLOCK * CHUNK * BLOCK)
        + (row % BLOCK) * (CHUNK * BLOCK)
        + (e_dst % CHUNK) * BLOCK
        + col % BLOCK
    )
    blocks = (
        np.bincount(flat, weights=weight,
                    minlength=n_store * BLOCK * CHUNK * BLOCK)
        .reshape(n_store, BLOCK, CHUNK * BLOCK)
        .astype(np.float32)
    )
    block_col = np.zeros(nnz_b, dtype=np.int32)
    block_col[dst] = (uniq % n_cb).astype(np.int32)
    cstart, clen, crow, cfirst, clast = _build_chunks(ptr, n_rb)
    row_scale = None
    if bd.SLAB_DTYPES[dtype] == torch.int8:
        # the row block that owns each storage chunk (clipped for the
        # placeholder chunk of an all-empty graph)
        rb_of_store = np.clip(
            np.searchsorted(ptr, np.arange(n_store) * CHUNK, side="right") - 1,
            0, n_rb - 1).astype(np.int64)
        row_max = np.zeros(n_rb * BLOCK, dtype=np.float32)
        np.maximum.at(row_max.reshape(n_rb, BLOCK), rb_of_store,
                      np.abs(blocks).max(axis=2))
        row_scale = np.where(row_max > 0, row_max / 127.0, 1.0).astype(
            np.float32)
        q = np.rint(
            blocks / row_scale.reshape(n_rb, BLOCK)[rb_of_store][:, :, None])
        blocks = torch.from_numpy(np.clip(q, -127, 127).astype(np.int8))
    else:
        blocks = torch.from_numpy(blocks).to(bd.SLAB_DTYPES[dtype])
    return dict(
        blocks=blocks,
        row_scale=row_scale,
        block_col=block_col,
        block_row_ptr=ptr,
        block_row_end=(ptr[:-1] + counts).astype(np.int32),
        chunk_start=cstart,
        chunk_len=clen,
        chunk_row=crow,
        chunk_first=cfirst,
        chunk_last=clast,
        n_rb=n_rb,
        n_cb=n_cb,
    )


def build_bcsr(row, col, weight, n_node: int, *, dtype: str = "float32",
               device="cpu") -> BCSR:
    """:func:`build_bcsr_arrays`, placed on ``device``."""
    a = build_bcsr_arrays(row, col, weight, n_node, dtype)
    arrays = {f.name: torch.as_tensor(a[f.name]).to(device)
              for f in fields(BCSR) if a.get(f.name) is not None
              and not isinstance(a[f.name], int)}
    return BCSR(**arrays, n_rb=a["n_rb"], n_cb=a["n_cb"], n_node=int(n_node))


def coo_is_symmetric(row: np.ndarray, col: np.ndarray, w: np.ndarray) -> bool:
    """True iff the weighted adjacency equals its transpose (host-side).
    Undirected graphs under 'sum'/'gcn' normalization are symmetric; 'mean'
    (D^-1 A) is not."""
    keep = w != 0
    row, col, w = row[keep], col[keep], w[keep]
    n = int(max(row.max(), col.max())) + 1 if row.size else 1
    k1 = row.astype(np.int64) * n + col
    k2 = col.astype(np.int64) * n + row
    o1 = np.argsort(k1, kind="stable")
    o2 = np.argsort(k2, kind="stable")
    return np.array_equal(k1[o1], k2[o2]) and np.allclose(w[o1], w[o2])


def _check(bcsr: BCSR, x: torch.Tensor) -> None:
    bd.check_operands("bcsr_spmm", bcsr.blocks, bcsr.row_scale, x,
                      (bcsr.block_col, bcsr.block_row_ptr,
                       bcsr.block_row_end))
    if x.shape[0] > bcsr.n_cb * BLOCK:
        raise ValueError(
            f"x has {x.shape[0]} rows; the layout's columns span "
            f"{bcsr.n_cb * BLOCK}")
    if any(t.dtype != torch.int32 for t in (
            bcsr.block_col, bcsr.block_row_ptr, bcsr.block_row_end)):
        raise TypeError("block_col, block_row_ptr and block_row_end must be "
                        "int32")
    if bcsr.row_scale is not None and \
            bcsr.row_scale.shape != (bcsr.n_rb * BLOCK,):
        raise ValueError(f"row_scale of shape {tuple(bcsr.row_scale.shape)} "
                         "does not hold one value per row")


def bcsr_spmm_reference(bcsr: BCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: gathers x's row
    blocks by block_col, multiplies each wide chunk with its stacked x blocks
    (``torch.bmm``, blocks widened to f32: every product exact, as on the
    MXU), adds each product into its row block (``index_add_``) and scales
    the rows. Returns (n_node, H) f32."""
    _check(bcsr, x)
    x = bd.x_operand(bcsr.blocks.dtype, x)
    h = x.shape[1]
    x_pad = x.new_zeros((bcsr.n_cb * BLOCK, h))
    x_pad[: x.shape[0]] = x
    n_store = bcsr.blocks.shape[0]
    xg = x_pad.view(bcsr.n_cb, BLOCK, h)[bcsr.block_col.long()]
    prod = torch.bmm(bcsr.blocks.float(), xg.view(n_store, CHUNK * BLOCK, h))
    live = bcsr.chunk_len > 0  # the placeholder chunks add nothing
    store = (bcsr.chunk_start[live] // CHUNK).long()
    out = x.new_zeros((bcsr.n_rb, BLOCK, h))
    out.index_add_(0, bcsr.chunk_row[live].long(), prod[store])
    out = out.view(-1, h)
    if bcsr.row_scale is not None:
        out = out * bcsr.row_scale[:, None]
    return out[: bcsr.n_node]


def _kernel() -> ctypes.CDLL:
    from glass_tpu_torch.ops import _build

    lib = _build.load("bcsr_spmm")
    fn = lib.glass_bcsr_spmm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def _launch(bcsr: BCSR, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x through the kernel (CUDA) or the plain version (CPU)."""
    if x.device.type == "cpu":
        return bcsr_spmm_reference(bcsr, x)
    if x.device.type != "cuda":
        raise ValueError(f"bcsr_spmm runs on 'cuda' or 'cpu', not {x.device}")
    h = x.shape[1]
    out = torch.empty((bcsr.n_node, h), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if x.shape[0] == 0:  # every row of x reads as zero
        return out.zero_()
    if bcsr.blocks.data_ptr() % 16:
        raise ValueError("the kernel reads blocks in 16-byte loads: their "
                         "storage must be 16-byte aligned")
    ld = h
    if bcsr.blocks.dtype != torch.float32:
        x, ld = bd.mma_x_operand(x)
    lib = _kernel()
    with torch.cuda.device(x.device):
        rc = lib.glass_bcsr_spmm(
            bcsr.blocks.data_ptr(), bd.DTYPE_CODES[bcsr.blocks.dtype],
            bcsr.blocks.shape[0], bcsr.block_col.data_ptr(),
            bcsr.block_row_ptr.data_ptr(), bcsr.block_row_end.data_ptr(),
            None if bcsr.row_scale is None else bcsr.row_scale.data_ptr(),
            x.data_ptr(), bd.DTYPE_CODES[x.dtype], ld, out.data_ptr(),
            x.shape[0], bcsr.n_node, h,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bcsr_spmm kernel launch failed: CUDA error {rc}")
    bcsr_spmm.launches += 1
    dt = str(bcsr.blocks.dtype).removeprefix("torch.")
    bcsr_spmm.launches_by_dtype[dt] = bcsr_spmm.launches_by_dtype.get(dt, 0) + 1
    return out


def bcsr_spmm(bcsr: BCSR, x: torch.Tensor,
              bcsr_t: Optional[BCSR] = None) -> torch.Tensor:
    """out = A @ x with A in BCSR form. x: (n, H) f32 or bf16 with
    n <= n_cb*128; returns (n_node, H) f32.

    A CUDA tensor goes to the hand-written kernel (``csrc/bcsr_spmm.cu``,
    built at first use) or raises; a CPU tensor goes to
    :func:`bcsr_spmm_reference`. With ``bcsr_t``, the layout of A^T (the
    same object when A is symmetric), the product is differentiable in x
    and the backward runs the same kernel over ``bcsr_t``, dx in x's dtype;
    without it, x must not need a gradient. ``bcsr_spmm.launches`` counts
    kernel launches, forward and backward, and
    ``bcsr_spmm.launches_by_dtype`` splits the count by block dtype."""
    _check(bcsr, x)
    return spmm_with_transpose(_launch, bcsr, x, bcsr_t, "bcsr_spmm")


bcsr_spmm.launches = 0
bcsr_spmm.launches_by_dtype = {}

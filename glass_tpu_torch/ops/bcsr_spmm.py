"""Chunked block-sparse (BCSR) adjacency and its SpMM.

Counterpart of ``glass_tpu/ops/pallas_spmm.py``. The host half builds the
same arrays as the JAX builder: the nonzero 128x128 blocks of the
normalized adjacency, each row block's run padded with zero blocks to a
multiple of ``CHUNK`` and stored as ``(n_store, 128, CHUNK*128)`` wide
chunks, with ``block_col``, ``block_row_ptr`` and the chunk tables. The
device half is :func:`bcsr_spmm`: on a CUDA tensor it launches the
hand-written kernel of ``csrc/bcsr_spmm.cu``, which replaces the two Pallas
kernels ``_bcsr_chunk_kernel`` and ``_bcsr_chunk_kernel_large``; on a CPU
tensor it runs :func:`bcsr_spmm_reference`, the kernel's plain PyTorch
version.

Only the f32 forward is ported; bf16/int8 blocks, the backward over the
transposed layout and rectangular (sharded) layouts are ROADMAP work.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields

import numpy as np
import torch

from glass_tpu_torch.ops._common import BLOCK

CHUNK = 8  # adjacency blocks per stored wide chunk


@dataclass(frozen=True)
class BCSR:
    """Block-sparse adjacency on one device.

    blocks[s] holds stored blocks s*CHUNK .. s*CHUNK+CHUNK-1 side by side;
    block_col[k] is stored block k's column block (0 on padding);
    block_row_ptr[rb] .. block_row_ptr[rb+1] is row block rb's block range.
    Chunk c covers blocks [chunk_start[c], chunk_start[c] + CHUNK) of row
    chunk_row[c]; chunk_len[c] is CHUNK, or 0 for the placeholder chunk of an
    empty row block; chunk_first/chunk_last flag each row's first/last
    chunk."""

    blocks: torch.Tensor  # (n_store, BLOCK, CHUNK*BLOCK) f32
    block_col: torch.Tensor  # (n_store*CHUNK,) int32
    block_row_ptr: torch.Tensor  # (n_rb + 1,) int32
    chunk_start: torch.Tensor  # (n_chunks,) int32
    chunk_len: torch.Tensor  # (n_chunks,) int32
    chunk_row: torch.Tensor  # (n_chunks,) int32
    chunk_first: torch.Tensor  # (n_chunks,) int32
    chunk_last: torch.Tensor  # (n_chunks,) int32
    n_rb: int
    n_cb: int
    n_node: int

    @property
    def nnz_blocks(self) -> int:
        """Stored block count (includes per-row CHUNK-alignment padding)."""
        return int(self.blocks.shape[0]) * CHUNK

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


def build_bcsr_arrays(row, col, weight, n_node: int) -> dict:
    """Host-side f32 BCSR construction from (already normalized) COO arrays;
    zero-weight edges are ignored and duplicate edges add up (accumulated in
    f64, then rounded to f32). Returns a dict of numpy arrays (blocks,
    block_col, block_row_ptr, chunk_start/len/row/first/last) plus n_rb and
    n_cb, equal to those of ``glass_tpu.ops.pallas_spmm.build_bcsr_arrays``
    for a square f32 layout."""
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
    return dict(
        blocks=blocks,
        block_col=block_col,
        block_row_ptr=ptr,
        chunk_start=cstart,
        chunk_len=clen,
        chunk_row=crow,
        chunk_first=cfirst,
        chunk_last=clast,
        n_rb=n_rb,
        n_cb=n_cb,
    )


def build_bcsr(row, col, weight, n_node: int, *, device="cpu") -> BCSR:
    """:func:`build_bcsr_arrays`, placed on ``device``."""
    a = build_bcsr_arrays(row, col, weight, n_node)
    arrays = {f.name: torch.from_numpy(a[f.name]).to(device)
              for f in fields(BCSR) if isinstance(a.get(f.name), np.ndarray)}
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
    if x.dim() != 2:
        raise ValueError(f"x must be (n, H), got shape {tuple(x.shape)}")
    if x.dtype != torch.float32 or bcsr.blocks.dtype != torch.float32:
        raise TypeError(
            f"bcsr_spmm takes float32 blocks and x, got {bcsr.blocks.dtype} "
            f"and {x.dtype}")
    if x.shape[0] > bcsr.n_cb * BLOCK:
        raise ValueError(
            f"x has {x.shape[0]} rows; the layout's columns span "
            f"{bcsr.n_cb * BLOCK}")
    if x.requires_grad or bcsr.blocks.requires_grad:
        raise RuntimeError(
            "bcsr_spmm has no autograd rule in this port yet: call it under "
            "torch.no_grad() or torch.inference_mode()")
    tensors = (bcsr.blocks, bcsr.block_col, bcsr.block_row_ptr, x)
    if any(t.device != x.device for t in tensors):
        raise ValueError("the BCSR layout and x must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bcsr_spmm takes contiguous tensors")
    if bcsr.block_col.dtype != torch.int32 or \
            bcsr.block_row_ptr.dtype != torch.int32:
        raise TypeError("block_col and block_row_ptr must be int32")


def bcsr_spmm_reference(bcsr: BCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: gathers x's row
    blocks by block_col, multiplies each wide chunk with its stacked x blocks
    (``torch.bmm``) and adds each product into its row block
    (``index_add_``). Returns (n_node, H) f32."""
    _check(bcsr, x)
    h = x.shape[1]
    x_pad = x.new_zeros((bcsr.n_cb * BLOCK, h))
    x_pad[: x.shape[0]] = x
    n_store = bcsr.blocks.shape[0]
    xg = x_pad.view(bcsr.n_cb, BLOCK, h)[bcsr.block_col.long()]
    prod = torch.bmm(bcsr.blocks, xg.view(n_store, CHUNK * BLOCK, h))
    live = bcsr.chunk_len > 0  # the placeholder chunks add nothing
    store = (bcsr.chunk_start[live] // CHUNK).long()
    out = x.new_zeros((bcsr.n_rb, BLOCK, h))
    out.index_add_(0, bcsr.chunk_row[live].long(), prod[store])
    return out.view(-1, h)[: bcsr.n_node]


def _kernel() -> ctypes.CDLL:
    from glass_tpu_torch.ops import _build

    lib = _build.load("bcsr_spmm")
    fn = lib.glass_bcsr_spmm_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def bcsr_spmm(bcsr: BCSR, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x with A in BCSR form. x: (n, H) f32 with n <= n_cb*128;
    returns (n_node, H) f32.

    A CUDA tensor goes to the hand-written kernel (``csrc/bcsr_spmm.cu``,
    built at first use) or raises; a CPU tensor goes to
    :func:`bcsr_spmm_reference`. ``bcsr_spmm.launches`` counts kernel
    launches."""
    _check(bcsr, x)
    if x.device.type == "cpu":
        return bcsr_spmm_reference(bcsr, x)
    if x.device.type != "cuda":
        raise ValueError(f"bcsr_spmm runs on 'cuda' or 'cpu', not {x.device}")
    h = x.shape[1]
    out = torch.empty((bcsr.n_node, h), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(x.device):
        rc = lib.glass_bcsr_spmm_f32(
            bcsr.blocks.data_ptr(), bcsr.block_col.data_ptr(),
            bcsr.block_row_ptr.data_ptr(), x.data_ptr(), out.data_ptr(),
            bcsr.n_rb, x.shape[0], bcsr.n_node, h,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bcsr_spmm kernel launch failed: CUDA error {rc}")
    bcsr_spmm.launches += 1
    return out


bcsr_spmm.launches = 0

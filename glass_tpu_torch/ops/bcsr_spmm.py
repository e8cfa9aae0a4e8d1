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

Layouts may be rectangular (``n_col`` columns, independent of the rows):
the sharded path's local-rows x global-columns layouts and their
transposes (``parallel/partition.py``), with an appended all-zero row
block (``pad_row_blocks``) that :func:`pad_bcsr_arrays` points the
cross-shard padding chunks at; ``block_row_end`` marks it empty, so the
kernel never reads the padding.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from glass_tpu_torch import native
from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import band_spmm as bd
from glass_tpu_torch.ops._common import BLOCK, on_card, spmm_with_transpose

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


@dataclass(frozen=True)
class BlockPattern:
    """The nonzero 128 x 128 blocks of an edge list (its edges of nonzero
    weight), row block by row block: row block rb's column blocks, in
    ascending order, are ``cb[ptr[rb]:ptr[rb + 1]]``, and ``cnt`` holds
    each block's edges. The planner prices every layout from it, and the
    BCSR build lays its blocks out by it, with no further pass over the
    edges."""

    ptr: np.ndarray  # (n_rb + 1,) int64
    cb: np.ndarray  # (n_blocks,) int32
    cnt: np.ndarray  # (n_blocks,) int64
    n_cb: int

    @property
    def n_rb(self) -> int:
        return self.ptr.shape[0] - 1

    @property
    def n_blocks(self) -> int:
        return int(self.cb.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.cnt.sum())

    def rb(self) -> np.ndarray:
        """Each block's row block, (n_blocks,) int64."""
        return np.repeat(np.arange(self.n_rb, dtype=np.int64),
                         np.diff(self.ptr))

    def select(self, keep: np.ndarray) -> "BlockPattern":
        """The pattern of the blocks ``keep`` marks."""
        per_rb = np.bincount(self.rb()[keep], minlength=self.n_rb)
        return BlockPattern(np.concatenate(([0], np.cumsum(per_rb))),
                            self.cb[keep], self.cnt[keep], self.n_cb)


def block_pattern(row, col, weight, n_rb: int, n_cb: int) -> BlockPattern:
    """The :class:`BlockPattern` of the edges of nonzero ``weight`` (every
    edge with ``weight`` None) over ``n_rb`` row and ``n_cb`` column
    blocks: in one pass of the native library over a row-sorted int32 edge
    list, else from numpy's ``np.unique`` of the block ids (the same
    arrays)."""
    row, col = np.asarray(row), np.asarray(col)
    if weight is not None:
        found = native.block_counts(row, col, np.asarray(weight), n_rb, n_cb)
        if found is not None:
            return BlockPattern(*found, n_cb)
        keep = np.asarray(weight) != 0
        row, col = row[keep], col[keep]
    bid = (row.astype(np.int64) // BLOCK) * n_cb + col // BLOCK
    uniq, cnt = np.unique(bid, return_counts=True)
    ptr = np.searchsorted(uniq // n_cb, np.arange(n_rb + 1)).astype(np.int64)
    return BlockPattern(ptr, (uniq % n_cb).astype(np.int32),
                        cnt.astype(np.int64), n_cb)


QUANT_BATCH = 256  # stored chunks quantized at a time (128 MiB of f32)


def _quantize_rows(blocks: np.ndarray, ptr: np.ndarray, n_rb: int):
    """(int8 blocks, (n_rb*128,) f32 row scales) of f32 wide chunks: each
    row of A scaled by its max |value| / 127 (1 for an empty row), rounded
    to nearest even and clipped to +-127, QUANT_BATCH chunks at a time (the
    same values as over the whole array at once)."""
    n_store = blocks.shape[0]
    # the row block that owns each storage chunk (clipped for the
    # placeholder chunk of an all-empty graph)
    rb_of_store = np.clip(
        np.searchsorted(ptr, np.arange(n_store) * CHUNK, side="right") - 1,
        0, n_rb - 1).astype(np.int64)
    store_max = np.empty((n_store, BLOCK), dtype=np.float32)
    for s0 in range(0, n_store, QUANT_BATCH):
        store_max[s0:s0 + QUANT_BATCH] = np.abs(
            blocks[s0:s0 + QUANT_BATCH]).max(axis=2)
    row_max = np.zeros(n_rb * BLOCK, dtype=np.float32)
    np.maximum.at(row_max.reshape(n_rb, BLOCK), rb_of_store, store_max)
    row_scale = np.where(row_max > 0, row_max / 127.0, 1.0).astype(np.float32)
    scale = row_scale.reshape(n_rb, BLOCK)
    q = np.empty(blocks.shape, dtype=np.int8)
    for s0 in range(0, n_store, QUANT_BATCH):
        part = blocks[s0:s0 + QUANT_BATCH]
        q[s0:s0 + QUANT_BATCH] = np.clip(np.rint(
            part / scale[rb_of_store[s0:s0 + QUANT_BATCH]][:, :, None]),
            -127, 127).astype(np.int8)
    return q, row_scale


def build_bcsr_arrays(row, col, weight, n_node: int,
                      dtype: str = "float32", n_col: Optional[int] = None,
                      pad_row_blocks: int = 0) -> dict:
    """Host-side BCSR construction from (already normalized) COO arrays;
    zero-weight edges are ignored and duplicate edges add up (accumulated in
    f64, then rounded to f32). ``dtype`` "float32", "bfloat16" or "int8":
    int8 quantizes each row of the accumulated blocks by its row's
    ``max|A[r, :]| / 127`` (1 for an empty row), rounds to nearest even and
    clips to +-127 (``pallas_spmm.py:219-243``).

    ``n_col`` (default ``n_node``) makes the layout rectangular, and
    ``pad_row_blocks`` appends that many empty row blocks (the targets of
    :func:`pad_bcsr_arrays`' padding chunks).

    Returns blocks (a CPU tensor of ``dtype``: numpy has no bf16),
    row_scale ((n_rb*128,) f32 numpy for int8, else None), the numpy index
    tables (block_col, block_row_ptr, chunk_start/len/row/first/last) and
    n_rb, n_cb, equal to those of
    ``glass_tpu.ops.pallas_spmm.build_bcsr_arrays``; and the port's skip
    table block_row_end ((n_rb,) int32, ``block_row_ptr[:-1]`` plus each
    row block's count of nonzero blocks)."""
    if dtype not in bd.SLAB_DTYPES:
        raise ValueError(f"unknown BCSR block dtype {dtype!r}")
    n_col = n_node if n_col is None else n_col
    row, col, weight = np.asarray(row), np.asarray(col), np.asarray(weight)
    if row.size and (min(row.min(), col.min()) < 0 or row.max() >= n_node
                     or col.max() >= n_col):
        raise ValueError(f"edge endpoints must lie in [0, {n_node}) x "
                         f"[0, {n_col})")
    n_rb = -(-n_node // BLOCK) + pad_row_blocks
    n_cb = -(-n_col // BLOCK)
    # A row-sorted int32 edge list (build_graph's, with the native library)
    # is laid out by its block pattern and filled in its own order; any other
    # is sorted by block first. Both give the same arrays.
    lean = native.block_counts(row, col, weight, n_rb, n_cb)
    if lean is not None:
        blk_ptr, ucb, _ = lean
        counts = np.diff(blk_ptr)
        urows = np.repeat(np.arange(n_rb, dtype=np.int64), counts)
    else:
        row, col = row.astype(np.int64), col.astype(np.int64)
        keep = weight != 0
        row, col, weight = row[keep], col[keep], weight[keep]
        bid = (row // BLOCK) * n_cb + col // BLOCK
        order = np.argsort(bid, kind="stable")
        row, col, weight, bid = (row[order], col[order], weight[order],
                                 bid[order])
        uniq, start = np.unique(bid, return_index=True)
        ends = np.append(start[1:], bid.shape[0])
        urows = uniq // n_cb
        ucb = uniq % n_cb
        counts = np.bincount(urows, minlength=n_rb)

    # Per-row CHUNK alignment: each row block's run is padded with zero
    # blocks (column 0) to a multiple of CHUNK, so every chunk is full and
    # lies within one row.
    padded_counts = -(-counts // CHUNK) * CHUNK  # 0 stays 0
    # >= CHUNK so an all-empty graph still stores one (zero) chunk
    nnz_b = max(int(padded_counts.sum()), CHUNK)
    ptr = np.zeros(n_rb + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(padded_counts).astype(np.int32)
    # destination slot of each real block: row's padded base + rank in row
    rank = np.arange(urows.shape[0]) - np.concatenate(
        ([0], np.cumsum(counts)[:-1])
    )[urows]
    dst = ptr[urows] + rank

    # Wide-chunk storage: stored chunk s is one (BLOCK, CHUNK*BLOCK) matrix
    # holding its CHUNK blocks side by side.
    n_store = nnz_b // CHUNK
    if lean is not None:
        blocks = native.bcsr_fill_rows(row, col, weight, blk_ptr, ucb, ptr,
                                       n_cb, CHUNK, n_store)
    else:
        # edges sorted by block: each edge's slot is its block's dst
        # repeated over the block's run
        e_dst = np.repeat(dst, ends - start)
        blocks = native.bcsr_fill(row, col, weight, e_dst, CHUNK, n_store)
        if blocks is None:  # flat bincount: the same f64 sums in edge order
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
    block_col[dst] = ucb.astype(np.int32)
    cstart, clen, crow, cfirst, clast = _build_chunks(ptr, n_rb)
    row_scale = None
    if bd.SLAB_DTYPES[dtype] == torch.int8:
        q, row_scale = _quantize_rows(blocks, ptr, n_rb)
        blocks = torch.from_numpy(q)
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


def pad_bcsr_arrays(a: dict, n_store: int, nnz_b: int, n_chunks: int) -> dict:
    """A :func:`build_bcsr_arrays` dict padded to the given sizes, so that
    every shard's layout has one shape (``pallas_spmm.py::pad_bcsr_arrays``):
    zero blocks, column-0 block slots, and copies of the empty-row
    placeholder chunk (length 0, first and last) on the layout's last row
    block, which ``pad_row_blocks >= 1`` makes an all-zero one whose output
    nobody reads. block_row_ptr and block_row_end are left as they are: the
    padding lies past the last row block's range."""
    out = dict(a)
    cur_store = a["blocks"].shape[0]
    cur_nnz = a["block_col"].shape[0]
    cur_chunks = a["chunk_start"].shape[0]
    if n_store < cur_store or nnz_b < cur_nnz or n_chunks < cur_chunks:
        raise ValueError("pad_bcsr_arrays only grows a layout")
    if n_store > cur_store:
        out["blocks"] = torch.cat([a["blocks"], a["blocks"].new_zeros(
            (n_store - cur_store,) + tuple(a["blocks"].shape[1:]))])
    if nnz_b > cur_nnz:
        out["block_col"] = np.concatenate(
            [a["block_col"], np.zeros(nnz_b - cur_nnz, np.int32)])
    k = n_chunks - cur_chunks
    if k:
        pad = {"chunk_start": 0, "chunk_len": 0, "chunk_row": a["n_rb"] - 1,
               "chunk_first": 1, "chunk_last": 1}
        for name, v in pad.items():
            out[name] = np.concatenate([a[name], np.full(k, v, np.int32)])
    return out


def build_bcsr(row, col, weight, n_node: int, *, dtype: str = "float32",
               n_col: Optional[int] = None, pad_row_blocks: int = 0,
               device="cpu") -> BCSR:
    """:func:`build_bcsr_arrays`, placed on ``device``."""
    return bcsr_from_arrays(
        build_bcsr_arrays(row, col, weight, n_node, dtype, n_col,
                          pad_row_blocks), n_node, device)


def bcsr_from_arrays(a: dict, n_node: int, device="cpu") -> BCSR:
    """The :class:`BCSR` of a :func:`build_bcsr_arrays` dict on ``device``,
    with ``n_node`` real output rows."""
    arrays = {f.name: torch.as_tensor(a[f.name]).to(device)
              for f in fields(BCSR) if a.get(f.name) is not None
              and not isinstance(a[f.name], int)}
    return BCSR(**arrays, n_rb=a["n_rb"], n_cb=a["n_cb"], n_node=int(n_node))


SYM_BATCH = 1 << 24  # edges compared at a time by coo_is_symmetric


def _row_col_sorted(row: np.ndarray, col: np.ndarray) -> bool:
    """True iff the edges are sorted by (row, col), looked at SYM_BATCH
    edges at a time."""
    for i in range(0, row.shape[0], SYM_BATCH):
        r = row[i: i + SYM_BATCH + 1]
        dr = np.diff(r)
        if (dr < 0).any() or (np.diff(col[i: i + SYM_BATCH + 1])[dr == 0]
                              < 0).any():
            return False
    return True


def coo_is_symmetric(row: np.ndarray, col: np.ndarray, w: np.ndarray) -> bool:
    """True iff the weighted adjacency equals its transpose (host-side).
    Undirected graphs under 'sum'/'gcn' normalization are symmetric; 'mean'
    (D^-1 A) is not.

    The rule: the edges of nonzero weight, stably sorted by (row, col) and
    by (col, row), hold the same keys, and their weights in the two orders
    are allclose. The edges stably sorted by (row, col) (build_graph's
    already are) are in the first order, and their stable order by column
    alone is the second: that order (the native library's counting sort,
    else numpy's stable argsort) is compared with them SYM_BATCH edges at a
    time, with no int64 key array."""
    keep = w != 0
    if not keep.all():
        row, col, w = row[keep], col[keep], w[keep]
    del keep
    if not _row_col_sorted(row, col):
        order = np.lexsort((col, row))
        row, col, w = row[order], col[order], w[order]
    n = int(max(row.max(), col.max())) + 1 if row.size else 1
    perm = native.col_order(col, n)
    if perm is None:
        perm = np.argsort(col, kind="stable")
    for i in range(0, row.shape[0], SYM_BATCH):
        p = perm[i: i + SYM_BATCH]
        if not (np.array_equal(row[i: i + SYM_BATCH], col[p])
                and np.array_equal(col[i: i + SYM_BATCH], row[p])
                and np.allclose(w[i: i + SYM_BATCH], w[p])):
            return False
    return True


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


def _launch(bcsr: BCSR, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x through the kernel (CUDA) or the plain version (CPU)."""
    if not on_card("bcsr_spmm", x):
        return bcsr_spmm_reference(bcsr, x)
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
    index = x.get_device()
    _build.launch(
        "bcsr_spmm", _build.load("bcsr_spmm").glass_bcsr_spmm, index,
        bcsr.blocks.data_ptr(), bd.DTYPE_CODES[bcsr.blocks.dtype],
        bcsr.blocks.shape[0], bcsr.block_col.data_ptr(),
        bcsr.block_row_ptr.data_ptr(), bcsr.block_row_end.data_ptr(),
        None if bcsr.row_scale is None else bcsr.row_scale.data_ptr(),
        x.data_ptr(), bd.DTYPE_CODES[x.dtype], ld, out.data_ptr(),
        x.shape[0], bcsr.n_node, h, torch._C._cuda_getCurrentRawStream(index))
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

"""HBM read-bandwidth probes (counterpart of the two Pallas bodies of
``tools/hbm_probe.py``), for ``tools/torch_hbm_probe.py``.

:func:`hbm_read` streams an f32 array of 512-lane rows from device memory
``iters`` times, chunk by chunk, each chunk as ``stripes`` stripe copies;
:func:`hbm_read2` reads stripe s of every chunk from array s. What they
return is the TPU kernels' touch of their buffers: rows 0-7, lanes 0-127 of
each chunk (of stripe 0), so

    hbm_read(x)[8i:8i+8]   = x[i*chunk_rows : +8, :128]
    hbm_read2(xs)[8i:8i+8] = xs[0][i*chunk_rows/S : +8, :128].

A CUDA tensor goes to the hand-written kernel of ``csrc/hbm_probe.cu``
(bulk copies on mbarriers, built at first use) or raises; a CPU tensor goes
to the plain version, the slice above. ``hbm_read.launches`` and
``hbm_read2.launches`` count the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops._common import on_card

LANES = 512  # f32 values per row: 2 KiB
ROW_BYTES = LANES * 4
NBUF = 2
MAX_STRIPES = 8
OUT_ROWS, OUT_LANES = 8, 128
# shared memory a CTA may take, so that two fit on an SM
SMEM_CAP = 110 * 1024
# an mbarrier phase counts at most 2^20 - 1 bytes of transactions
TX_LIMIT = (1 << 20) - 1
BARRIER_BYTES = NBUF * MAX_STRIPES * 8


def check_shape(rows: int, chunk_rows: int, stripes: int, iters: int) -> tuple:
    """(n_steps, rows per stripe) of a probe over ``rows`` rows; raises
    ``ValueError`` where the TPU probe's asserts (or the stripe rule) do
    not hold."""
    if not 1 <= stripes <= MAX_STRIPES:
        raise ValueError(f"stripes must lie in [1, {MAX_STRIPES}], got "
                         f"{stripes}")
    if iters < 1:
        raise ValueError(f"iters must be at least 1, got {iters}")
    if chunk_rows < 1 or chunk_rows % stripes:
        raise ValueError(f"chunk_rows {chunk_rows} must be a positive "
                         f"multiple of stripes {stripes}")
    rows_s = chunk_rows // stripes
    if rows_s < OUT_ROWS:
        raise ValueError(f"each stripe must hold at least {OUT_ROWS} rows, "
                         f"got {rows_s}")
    if rows % chunk_rows:
        raise ValueError(f"rows {rows} must be a multiple of chunk_rows "
                         f"{chunk_rows}")
    n_steps = rows // chunk_rows
    if n_steps < NBUF or n_steps % NBUF:
        raise ValueError(f"the chunk count {n_steps} must be a positive "
                         f"multiple of {NBUF} (the double buffer)")
    return n_steps, rows_s


def _check_array(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2 or x.shape[1] != LANES or x.dtype != torch.float32:
        raise ValueError(f"{what} must be (rows, {LANES}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def hbm_read_reference(x: torch.Tensor, chunk_rows: int, stripes: int,
                       iters: int) -> torch.Tensor:
    """The plain version of :func:`hbm_read`: (n_steps*8, 128) f32."""
    _check_array(x, "x")
    n_steps, _ = check_shape(x.shape[0], chunk_rows, stripes, iters)
    return x.view(n_steps, chunk_rows, LANES)[:, :OUT_ROWS, :OUT_LANES] \
        .reshape(n_steps * OUT_ROWS, OUT_LANES)


def _read2_shape(xs: Sequence[torch.Tensor], chunk_rows: int, iters: int):
    stripes = len(xs)
    for i, a in enumerate(xs):
        _check_array(a, f"xs[{i}]")
        if a.shape != xs[0].shape or a.device != xs[0].device:
            raise ValueError("the read2 arrays must share one shape and device")
    rows_s = chunk_rows // stripes if stripes else 0
    if stripes == 0 or rows_s == 0 or xs[0].shape[0] % rows_s:
        raise ValueError(f"each of the {stripes} arrays must hold whole "
                         f"stripes of chunk_rows / S rows")
    rows = xs[0].shape[0] // rows_s * chunk_rows
    return check_shape(rows, chunk_rows, stripes, iters)


def hbm_read2_reference(xs: Sequence[torch.Tensor], chunk_rows: int,
                        iters: int) -> torch.Tensor:
    """The plain version of :func:`hbm_read2`: (n_steps*8, 128) f32."""
    n_steps, rows_s = _read2_shape(xs, chunk_rows, iters)
    return xs[0].view(n_steps, rows_s, LANES)[:, :OUT_ROWS, :OUT_LANES] \
        .reshape(n_steps * OUT_ROWS, OUT_LANES)


def tiling(rows_s: int, stripes: int, sms: int) -> tuple:
    """(ctas, q, smem bytes): q rows of every stripe per CTA, about two
    CTAs per SM, the tile within ``SMEM_CAP`` and each stripe's copy within
    the mbarrier's transaction limit."""
    q = -(-rows_s // (2 * sms))
    q_cap = min((SMEM_CAP - BARRIER_BYTES) // (NBUF * stripes * ROW_BYTES),
                TX_LIMIT // ROW_BYTES)
    q = max(1, min(q, q_cap))
    ctas = -(-rows_s // q)
    return ctas, q, NBUF * stripes * q * ROW_BYTES + BARRIER_BYTES


def _launch(bases: Sequence[torch.Tensor], base_rows: Sequence[int],
            chunk_stride_rows: int, rows_s: int, n_steps: int,
            iters: int) -> torch.Tensor:
    """One kernel launch; stripe s starts at row base_rows[s] of
    bases[s]."""
    dev = bases[0].device
    ptrs = [b.data_ptr() + r * ROW_BYTES for b, r in zip(bases, base_rows)]
    if any(p % 16 for p in ptrs):
        raise ValueError("the bulk copies need 16-byte-aligned rows")
    stripes = len(ptrs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas, q, smem = tiling(rows_s, stripes, sms)
    out = torch.empty((n_steps * OUT_ROWS, OUT_LANES), dtype=torch.float32,
                      device=dev)
    arr = (ctypes.c_void_p * stripes)(*ptrs)
    index = bases[0].get_device()
    _build.launch(
        "hbm_probe", _build.load("hbm_probe").glass_hbm_read, index, arr,
        stripes, chunk_stride_rows, rows_s, q, n_steps, iters, out.data_ptr(),
        ctas, smem, torch._C._cuda_getCurrentRawStream(index))
    return out


def hbm_read(x: torch.Tensor, chunk_rows: int, stripes: int,
             iters: int) -> torch.Tensor:
    """Reads x (rows, 512) f32 ``iters`` times in chunks of ``chunk_rows``
    rows, ``stripes`` copies per chunk; returns (n_steps*8, 128) f32 (see
    the module docstring)."""
    _check_array(x, "x")
    n_steps, rows_s = check_shape(x.shape[0], chunk_rows, stripes, iters)
    if not on_card("hbm_read", x):
        return hbm_read_reference(x, chunk_rows, stripes, iters)
    out = _launch([x] * stripes, [s * rows_s for s in range(stripes)],
                  chunk_rows, rows_s, n_steps, iters)
    hbm_read.launches += 1
    return out


def hbm_read2(xs: Sequence[torch.Tensor], chunk_rows: int,
              iters: int) -> torch.Tensor:
    """As :func:`hbm_read`, stripe s of each chunk read from ``xs[s]`` (S
    arrays of n_steps * chunk_rows/S rows)."""
    n_steps, rows_s = _read2_shape(xs, chunk_rows, iters)
    if not on_card("hbm_read2", xs[0]):
        return hbm_read2_reference(xs, chunk_rows, iters)
    out = _launch(list(xs), [0] * len(xs), rows_s, rows_s, n_steps, iters)
    hbm_read2.launches += 1
    return out


hbm_read.launches = 0
hbm_read2.launches = 0

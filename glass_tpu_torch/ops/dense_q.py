"""Row-quantized int8 dense adjacency and its SpMM.

Counterpart of ``glass_tpu/ops/pallas_dense.py``. Each row of the dense
normalized adjacency is quantized symmetrically, ``A[i, :] ~= q[i, :] *
scale[i]`` with ``q = round(A / scale)`` in int8 and ``scale = rowmax/127``
(1 for an all-zero row), and the product is

    out = scale[row] * (q.int8 -> bf16 @ x.bf16)

with the sum in f32 (``pallas_dense.py::_kernel``). On a CUDA tensor
:func:`dense_q_spmm` launches the hand-written kernel of
``csrc/dense_q_spmm.cu`` (a TMA ring feeding wgmma): x is rounded to bf16
once here, as the JAX wrapper rounds it (``pallas_dense.py:147``), and
handed to the kernel transposed (:func:`x_operand`); one launch covers the
whole product. The 1024-lane feature panels of the JAX wrapper were a VMEM
limit and have no counterpart here. On a CPU tensor the plain version
:func:`dense_q_spmm_reference` runs instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import band_spmm as bd
from glass_tpu_torch.ops._common import BLOCK, on_card, spmm_with_transpose


@dataclass(frozen=True)
class DenseQ:
    """Row-quantized dense adjacency on one device.

    q is zero past (n_row, n_col); scale[r] is row r's dequantization scale
    (0 on the padding rows). The JAX layout keeps the scale as
    (n_rp*128, 128), a lane broadcast for the TPU's tiling."""

    q: torch.Tensor  # (n_rp*BLOCK, n_cp*BLOCK) int8
    scale: torch.Tensor  # (n_rp*BLOCK,) f32
    n_row: int
    n_col: int

    @property
    def n_node(self) -> int:
        return self.n_row


def _pad_to(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def build_dense_q(dense: np.ndarray, *, device="cpu") -> DenseQ:
    """Quantizes a host-side dense adjacency row-wise to int8, as
    ``pallas_dense.py::build_dense_q`` does, placed on ``device``."""
    dense = np.asarray(dense, dtype=np.float32)
    n_row, n_col = dense.shape
    rp, cp = _pad_to(n_row), _pad_to(n_col)
    smax = np.abs(dense).max(axis=1) if n_col else np.zeros(n_row, np.float32)
    scale = np.where(smax > 0, smax / 127.0, 1.0).astype(np.float32)
    q = np.zeros((rp, cp), dtype=np.int8)
    q[:n_row, :n_col] = np.round(dense / scale[:, None]).astype(np.int8)
    sc = np.zeros(rp, dtype=np.float32)
    sc[:n_row] = scale
    return DenseQ(q=torch.from_numpy(q).to(device),
                  scale=torch.from_numpy(sc).to(device),
                  n_row=int(n_row), n_col=int(n_col))


def dense_q_bytes(n_row: int, n_col: int) -> int:
    """Stored bytes of one direction's layout, counted as the JAX package
    counts them (its scale is 128 lanes wide)."""
    return _pad_to(n_row) * _pad_to(n_col) + _pad_to(n_row) * BLOCK * 4


def dense_q_vmem_ok(n_row: int, n_col: int, hp: int = BLOCK) -> bool:
    """The reference's layout rule (``pallas_dense.py::dense_q_vmem_ok``),
    kept so that ``build_graph`` builds the int8 layout where the JAX
    builder does, and the bf16 dense matrix where it does not: True if the
    TPU kernel's working set at a one-block row panel (double-buffered int8
    panel, scales and output, with x resident as bf16) fits the band's
    15.5 MiB layout budget. Not a fact about the H100; its refit is ROADMAP
    Queue 1 item 6."""
    del n_row  # the rule depends on the column count alone
    n_cp, hp = _pad_to(n_col), max(hp, BLOCK)
    x_bytes = n_cp * hp * 2
    panel = 2 * (BLOCK * n_cp + BLOCK * BLOCK * 4 + BLOCK * hp * 4)
    return x_bytes + panel <= bd.LAYOUT_BUDGET_BYTES


def _check(dq: DenseQ, x: torch.Tensor) -> None:
    bd.check_operands("dense_q_spmm", dq.q, dq.scale, x)
    if x.shape[0] > dq.n_col:
        raise ValueError(f"x has {x.shape[0]} rows; the layout has "
                         f"{dq.n_col} columns")
    if dq.q.dim() != 2 or dq.q.shape[0] % BLOCK or dq.q.shape[1] % BLOCK \
            or dq.scale.shape != (dq.q.shape[0],):
        raise ValueError("q must be (n_rp*128, n_cp*128) with one scale "
                         "per row")


def dense_q_spmm_reference(dq: DenseQ, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: q widened to f32
    times x rounded to bf16 and widened (every product exact), scaled by
    row. Returns (n_row, H) f32."""
    _check(dq, x)
    xb = x.to(torch.bfloat16).float()
    x_pad = xb.new_zeros((dq.q.shape[1], xb.shape[1]))
    x_pad[: xb.shape[0]] = xb
    return (torch.matmul(dq.q.float(), x_pad)
            * dq.scale[:, None])[: dq.n_row]


def x_operand(x: torch.Tensor, k_pad: int) -> torch.Tensor:
    """x rounded to bf16 once (to nearest even, as ``band_spmm.x_operand``
    rounds it for int8 slabs), transposed and zero-padded to (H, k_pad):
    the kernel's B operand, k contiguous."""
    xt = x.new_zeros((x.shape[1], k_pad), dtype=torch.bfloat16)
    xt[:, : x.shape[0]] = x.t()
    return xt


def _launch(dq: DenseQ, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x through the kernel (CUDA) or the plain version (CPU).
    On a card, one call of ``csrc/dense_q_spmm.cu`` on checked operands:
    (n_row, H) f32."""
    if not on_card("dense_q_spmm", x):
        return dense_q_spmm_reference(dq, x)
    h = x.shape[1]
    out = torch.empty((dq.n_row, h), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    m_pad, k_pad = dq.q.shape
    xt = x_operand(x, k_pad)
    if dq.q.data_ptr() % 16:
        raise ValueError("the kernel reads q by TMA: its storage must be "
                         "16-byte aligned")
    index = x.get_device()
    _build.launch(
        "dense_q_spmm", _build.load("dense_q_spmm").glass_dense_q_spmm, index,
        dq.q.data_ptr(), dq.scale.data_ptr(), xt.data_ptr(), out.data_ptr(),
        m_pad, k_pad, dq.n_row, h, torch._C._cuda_getCurrentRawStream(index))
    dense_q_spmm.launches += 1
    return out


def dense_q_spmm(dq: DenseQ, dq_t: Optional[DenseQ], x: torch.Tensor) -> torch.Tensor:
    """out = A @ x through the int8 layout. x: (n, H) f32 or bf16 with
    n <= n_col; returns (n_row, H) f32.

    A CUDA tensor goes to the hand-written kernel of
    ``csrc/dense_q_spmm.cu`` (built at first use) or raises; a CPU tensor
    goes to :func:`dense_q_spmm_reference`. With ``dq_t``, the layout of A^T (the
    same object when A is symmetric), the product is differentiable in x:
    dx = A^T @ g through ``dq_t``, in x's dtype (``pallas_dense.py:165-190``).
    ``dense_q_spmm.launches`` counts kernel launches, forward and backward."""
    _check(dq, x)
    return spmm_with_transpose(_launch, dq, x, dq_t, "dense_q_spmm")


dense_q_spmm.launches = 0

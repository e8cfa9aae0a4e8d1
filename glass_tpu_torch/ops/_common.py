"""Shared constants, the device policy of the port's entry points, and the
autograd rule of the block-sparse kernels.

Counterpart of ``glass_tpu/ops/_pallas_common.py`` (which this package does
not import: it keeps its own copy of what it needs).
"""

from __future__ import annotations

from typing import Callable

import torch

# 128x128 adjacency block edge shared by every block-sparse layout.
BLOCK = 128


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point computes on.

    ``"cuda"`` (the default) raises when no card is present: the port never
    falls back to the CPU. Pass ``device="cpu"`` to run the plain PyTorch
    versions of the kernels on the CPU.

    Also turns TF32 off for matrix products and convolutions, so every f32
    product runs in full f32 — the counterpart of the JAX package's
    ``Precision.HIGHEST`` (``glass_tpu/ops/spmm.py``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


class _TransposedSpmm(torch.autograd.Function):
    """out = A @ x; dx = A^T @ g, the same kernel over the transposed
    layout (``glass_tpu``'s custom VJPs ``_make_diff_bcsr_spmm``,
    ``_make_diff_band_spmm`` and ``dense_q_spmm``). The layouts are data:
    they ride on ``ctx`` (not ``save_for_backward``) and get no gradient.
    The kernels sum in f32; dx is cast to the primal x's dtype, as the JAX
    VJPs cast it (``pallas_band.py:1151``, ``pallas_dense.py:182``)."""

    @staticmethod
    def forward(ctx, x, launch, layout, layout_t):
        ctx.launch, ctx.layout_t, ctx.x_dtype = launch, layout_t, x.dtype
        return launch(layout, x)

    @staticmethod
    def backward(ctx, g):
        dx = ctx.launch(ctx.layout_t, g.contiguous()).to(ctx.x_dtype)
        return dx, None, None, None


def spmm_with_transpose(launch: Callable, layout, x: torch.Tensor,
                        layout_t, name: str) -> torch.Tensor:
    """``launch(layout, x)``, differentiable in x when ``layout_t`` (the
    layout of A^T; ``layout`` itself when A is symmetric) is given. Without
    it, x must not need a gradient: the launch alone records none."""
    if layout_t is None:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                f"{name} needs the transposed layout for autograd")
        return launch(layout, x)
    if x.shape[0] != layout.n_node or layout_t.n_node != layout.n_node:
        raise ValueError(
            f"differentiable {name} takes x of {layout.n_node} rows and a "
            f"square pair of layouts, got x rows {x.shape[0]}, transposed "
            f"layout rows {layout_t.n_node}")
    return _TransposedSpmm.apply(x, launch, layout, layout_t)

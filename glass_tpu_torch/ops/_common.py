"""Shared constants, the device policy of the port's entry points and
kernel wrappers, and the autograd rule of the block-sparse kernels.

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


def on_card(name: str, x: torch.Tensor) -> bool:
    """Every kernel wrapper's path: True for a CUDA tensor (the
    hand-written kernel), False for a CPU tensor (the plain version);
    raises ``ValueError`` naming the wrapper ``name`` on any other
    device. There is no fallback between the two."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{name} runs on 'cuda' or 'cpu', not {x.device}")
    return False


class _TransposedSpmm(torch.autograd.Function):
    """out = A @ x; dx = A^T @ g, the same kernel over the transposed
    layout (``glass_tpu``'s custom VJPs ``_make_diff_bcsr_spmm``,
    ``_make_diff_band_spmm`` and ``dense_q_spmm``). The layouts are data:
    they ride on ``ctx`` (not ``save_for_backward``) and get no gradient.
    The kernels sum in f32; dx is cast to the primal x's dtype, as the JAX
    VJPs cast it (``pallas_band.py:1151``, ``pallas_dense.py:182``). A
    backward on a card adds one to ``spmm_with_transpose.transposed_launches``
    (the kernel's own counter counts the launch too)."""

    @staticmethod
    def forward(ctx, x, launch, layout, layout_t):
        ctx.launch, ctx.layout_t, ctx.x_dtype = launch, layout_t, x.dtype
        return launch(layout, x)

    @staticmethod
    def backward(ctx, g):
        dx = ctx.launch(ctx.layout_t, g.contiguous()).to(ctx.x_dtype)
        if g.is_cuda:
            spmm_with_transpose.transposed_launches += 1
        return dx, None, None, None


def spmm_with_transpose(launch: Callable, layout, x: torch.Tensor,
                        layout_t, name: str) -> torch.Tensor:
    """``launch(layout, x)``, differentiable in x when ``layout_t`` (the
    layout of A^T; ``layout`` itself when A is symmetric) is given. Without
    it, x must not need a gradient: the launch alone records none. The pair
    may be rectangular: x has the transposed layout's rows."""
    if layout_t is None:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                f"{name} needs the transposed layout for autograd")
        return launch(layout, x)
    cols_t = (layout_t.n_cb * BLOCK if hasattr(layout_t, "n_cb")
              else layout_t.n_col)
    if x.shape[0] != layout_t.n_node or layout.n_node > cols_t:
        raise ValueError(
            f"differentiable {name} takes x of as many rows as the transposed "
            f"layout's ({layout_t.n_node}), whose columns must span the "
            f"layout's {layout.n_node} rows; got x rows {x.shape[0]}, "
            f"transposed columns {cols_t}")
    return _TransposedSpmm.apply(x, launch, layout, layout_t)


spmm_with_transpose.transposed_launches = 0

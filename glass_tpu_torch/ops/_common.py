"""Shared constants and the device policy of the port's entry points.

Counterpart of ``glass_tpu/ops/_pallas_common.py`` (which this package does
not import: it keeps its own copy of what it needs).
"""

from __future__ import annotations

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

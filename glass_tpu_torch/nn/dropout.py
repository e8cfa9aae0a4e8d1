"""Dropout with an explicit generator (counterpart of
``glass_tpu/nn/dropout.py::HWDropout``).

The semantics are the JAX module's: P(keep) = 1 - rate with inverted
scaling (kept values divided by 1 - rate); the identity at rate 0 or when
not training; zeros at rate 1. The mask is drawn with ``torch.rand`` from
the ``torch.Generator`` the caller passes, on the tensor's device, so a
training run on the card draws its masks there and one seed gives one
stream. That stream differs from the TPU's hardware RNG by design (ROADMAP
Queue 3, "Limits of parity"): parity tests run with dropout off.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit generator."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate {rate} is not in [0, 1]")
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, *, training: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError(
                "training with dropout needs an explicit torch.Generator on "
                "the tensor's device")
        keep = torch.rand(x.shape, generator=generator, device=x.device) \
            >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)

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
                generator: Optional[torch.Generator] = None,
                rows: Optional[tuple] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``rows`` = (first global row, global rows) of a node block
        (``Graph.node_rows``): the mask is drawn for every global row and
        this block's rows are kept (its padding rows past the global count
        keep their values), so that the masks do not depend on how the
        graph is sharded and every data rank draws the same ones. ``keep``,
        where given, is the mask :meth:`draw` drew for this call, and
        nothing is drawn."""
        if not training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if keep is None:
            keep = self.draw(x.shape, x.device, training=training,
                             generator=generator, rows=rows)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)

    def draw(self, shape, device, *, training: bool,
             generator: Optional[torch.Generator] = None,
             rows: Optional[tuple] = None) -> Optional[torch.Tensor]:
        """The bool keep-mask that :meth:`forward` draws for an x of
        ``shape`` on ``device``, drawn now (None where forward draws
        nothing: not training, or the rate 0 or 1). A caller whose forward
        runs twice (a checkpointed body recomputed in the backward pass)
        draws it once and passes it to both as ``keep``."""
        if not training or self.rate in (0.0, 1.0):
            return None
        if generator is None:
            raise ValueError(
                "training with dropout needs an explicit torch.Generator on "
                "the tensor's device")
        if rows is None:
            u = torch.rand(shape, generator=generator, device=device)
        else:
            off, total = rows
            u = torch.rand((total,) + tuple(shape[1:]), generator=generator,
                           device=device)[off: off + shape[0]]
            if u.shape[0] < shape[0]:
                u = torch.cat([u, u.new_ones((shape[0] - u.shape[0],)
                                             + tuple(shape[1:]))])
        return u >= self.rate

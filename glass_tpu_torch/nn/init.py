"""Parameter initializers with torch's default distributions, drawn from an
explicit ``torch.Generator`` (counterpart of ``glass_tpu/nn/init.py``).

- ``nn.Linear``: weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
- ``nn.Embedding``: N(0, 1).
- GraphNorm: weight=1, bias=0, mean_scale=1 (constants, no draw).
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def torch_linear_(weight: torch.Tensor, bias: torch.Tensor,
                  generator: torch.Generator) -> None:
    """Fills a (out, in) Linear weight and its bias in place."""
    bound = 1.0 / math.sqrt(weight.shape[1])
    weight.uniform_(-bound, bound, generator=generator)
    bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_embedding_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Fills an embedding table with N(0, 1) in place."""
    weight.normal_(generator=generator)

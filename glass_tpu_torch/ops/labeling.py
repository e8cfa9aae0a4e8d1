"""The zero-one labeling trick (counterpart of ``glass_tpu/ops/labeling.py``).

Every node that appears in any subgraph of the batch gets z=1, all other
nodes z=0 (reference: impl/utils.py:32-45 MaxZOZ).
"""

from __future__ import annotations

import torch


def max_zero_one(pos: torch.Tensor, n_node: int) -> torch.Tensor:
    """Zero-one node labels for one subgraph batch.

    Args:
      pos: (B, L) padded subgraph node matrix, pad = -1.
      n_node: number of nodes in the background graph.

    Returns:
      (n_node,) int32 vector with 1 on nodes covered by the batch.
    """
    mask = pos >= 0
    safe = torch.where(mask, pos, 0).reshape(-1).long()
    vals = mask.to(torch.int32).reshape(-1)
    # scatter-max: padding entries write max(z[0], 0), a no-op
    z = torch.zeros(n_node, dtype=torch.int32, device=pos.device)
    return z.scatter_reduce_(0, safe, vals, reduce="amax")

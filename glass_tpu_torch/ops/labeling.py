"""The zero-one labeling trick and the padded-matrix <-> batch-vector
conversions (counterpart of ``glass_tpu/ops/labeling.py``).

Every node that appears in any subgraph of the batch gets z=1, all other
nodes z=0 (reference: impl/utils.py:32-45 MaxZOZ); ``max_zero_one_local``
labels one node block of a sharded graph. ``pad2batch`` and ``batch2pad``
are host-side numpy conveniences kept for API parity (reference:
impl/utils.py:5-29); pooling consumes the padded matrix directly
(``ops/segment.py``).
"""

from __future__ import annotations

import numpy as np
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


def max_zero_one_local(pos: torch.Tensor, n_local: int,
                       offset: int) -> torch.Tensor:
    """Zero-one labels restricted to the node block [offset, offset +
    n_local): the sharded counterpart of :func:`max_zero_one`
    (``glass_tpu/ops/labeling.py:38``). Each graph rank labels the nodes it
    owns; an all-reduce (max) over the data axis then gives every data
    rank the whole batch's labels."""
    idx = pos - offset
    valid = (pos >= 0) & (idx >= 0) & (idx < n_local)
    safe = torch.where(valid, idx, 0).reshape(-1).long()
    vals = valid.to(torch.int32).reshape(-1)
    z = torch.zeros(n_local, dtype=torch.int32, device=pos.device)
    return z.scatter_reduce_(0, safe, vals, reduce="amax")


def pad2batch(pad: np.ndarray):
    """[[0,2,3],[1,4,5],[6,7,-1]] -> batch [0,0,0,1,1,1,2,2], pos [0,2,3,...]."""
    pad = np.asarray(pad)
    batch = np.repeat(np.arange(pad.shape[0]), pad.shape[1])
    pos = pad.ravel()
    idx = pos >= 0
    return batch[idx], pos[idx]


def batch2pad(batch: np.ndarray) -> np.ndarray:
    """batch [0,1,0,0,1,1,2,2] -> pad [[0,2,3],[1,4,5],[6,7,-1]]."""
    batch = np.asarray(batch)
    uni = np.unique(batch)
    uni = uni[uni >= 0]
    idx = np.arange(batch.shape[0])
    groups = [idx[batch == u] for u in uni]
    width = max((len(g) for g in groups), default=0)
    out = np.full((len(groups), width), -1, dtype=np.int64)
    for i, g in enumerate(groups):
        out[i, : len(g)] = g
    return out

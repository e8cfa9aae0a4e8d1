"""Inference path: serve padded-bucket batches of subgraphs (counterpart of
``glass_tpu/serve.py``).

Each request's ragged subgraph lists are padded with -1 up to a fixed
(batch, width) bucket, as in the JAX package; the graph, the node features
and the model stay resident on the device.

Example:
    graph = build_graph(edge_index, None, n, "gcn", materialize_bcsr=True,
                        sparse_layout="bcsr")
    model = GLASS(max_deg, 64, 1, (1,), ("size",), spmm_mode="pallas")
    predictor = Predictor.from_checkpoint(model, graph, x, "ckpt.npz")
    logits = predictor([[0, 1, 2], [7, 9]])
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from glass_tpu_torch.ops._common import resolve_device
from glass_tpu_torch.ops.graph import Graph
from glass_tpu_torch.ops.labeling import max_zero_one


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}")


class Predictor:
    """Batched GLASS inference over shape buckets.

    ``x`` is the (N, C) integer feature-id tensor. The model, graph and x
    must lie on ``device`` ("cuda" by default; raises without a card)."""

    def __init__(
        self,
        model: torch.nn.Module,
        graph: Graph,
        x: torch.Tensor,
        *,
        use_z: bool = True,
        batch_buckets: Sequence[int] = (1, 8, 64, 256),
        width_buckets: Sequence[int] = (16, 64, 256),
        device="cuda",
    ):
        self.device = resolve_device(device)
        on = {"graph": graph.device, "x": x.device}
        on.update({name: p.device for name, p in model.named_parameters()})
        wrong = sorted(k for k, d in on.items() if d.type != self.device.type)
        if wrong:
            raise ValueError(f"{wrong} not on the predictor's device {self.device}")
        self.model = model.eval()
        self.graph = graph
        self.x = x
        self.use_z = use_z
        self.batch_buckets = tuple(batch_buckets)
        self.width_buckets = tuple(width_buckets)

    @classmethod
    def from_checkpoint(cls, model, graph, x, path, **kw) -> "Predictor":
        """Loads a ``glass_tpu`` ``.npz`` parameter checkpoint into ``model``."""
        from glass_tpu_torch.utils.checkpoint import load_checkpoint, params_from_flax

        params_from_flax(model, load_checkpoint(path))
        return cls(model, graph, x, **kw)

    def __call__(self, subgraphs: List[Sequence[int]]) -> np.ndarray:
        """Returns (len(subgraphs), C) logits as numpy."""
        n = len(subgraphs)
        width = max((len(s) for s in subgraphs), default=1)
        b = _bucket(n, self.batch_buckets)
        w = _bucket(width, self.width_buckets)
        pos = np.full((b, w), -1, dtype=np.int64)
        for i, s in enumerate(subgraphs):
            pos[i, : len(s)] = np.asarray(s, dtype=np.int64)
        with torch.inference_mode():
            pos_t = torch.from_numpy(pos).to(self.device)
            z = max_zero_one(pos_t, self.graph.n_node) if self.use_z else None
            logits = self.model(self.graph, self.x, pos_t, z)
            return logits.cpu().numpy()[:n]

"""Inference path: serve padded-bucket batches of subgraphs (counterpart of
``glass_tpu/serve.py``).

Each request's ragged subgraph lists are padded with -1 up to a fixed
(batch, width) bucket, as in the JAX package; the graph, the node features
and the model stay resident on the device. Where JAX jit-compiles the
forward once per bucket, the port on a CUDA card captures it once per
bucket (``utils/graphs.py``): the first request that lands in a bucket runs
the forward eagerly on the predictor's own stream and the capture follows;
every later request of the bucket fills a pinned host buffer, copies it
into the program's static (b, w) ``pos``, replays (the zero-one labels
included) and copies the logits back once. On the CPU every request runs
eagerly.

Under a profiler each request records a ``glass.serve.request`` span (its
sequence number the ident) whose three children cover the call:
``glass.serve.stage`` (the bucket and the pinned ``pos``),
``glass.serve.launch`` (the copy into the static buffers and the replay's
enqueue, or the eager first call and the capture, ``glass.capture``) and
``glass.serve.readback`` (the logits to the host, the wait for the device
included); the counters ``serve.nodes`` and ``serve.slots`` add its real
node slots and its bucket's b x w (``utils/profiling.py``).

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
from glass_tpu_torch.utils.graphs import InferencePrograms
from glass_tpu_torch.utils.profiling import count, recording, span


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}")


class Predictor:
    """Batched GLASS inference over shape buckets, one captured program a
    bucket on a CUDA card.

    ``x`` is the (N, C) integer feature-id tensor. The model, graph and x
    must lie on ``device`` ("cuda" by default; raises without a card). The
    private ``_graphed`` cleared serves eagerly on the card, for comparisons
    only."""

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
        self._graphed = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._graphed
                        else None)
        self._programs = InferencePrograms(self.device)
        self._staging: dict = {}  # (b, w) -> the bucket's host pos buffer
        self._requests = 0  # calls so far, the request spans' ident

    @classmethod
    def from_checkpoint(cls, model, graph, x, path, **kw) -> "Predictor":
        """Loads a ``glass_tpu`` ``.npz`` parameter checkpoint into ``model``."""
        from glass_tpu_torch.utils.checkpoint import load_checkpoint, params_from_flax

        params_from_flax(model, load_checkpoint(path))
        return cls(model, graph, x, **kw)

    def _forward(self, pos: torch.Tensor) -> torch.Tensor:
        z = max_zero_one(pos, self.graph.n_node) if self.use_z else None
        return self.model(self.graph, self.x, pos, z)

    def _host_pos(self, b: int, w: int) -> torch.Tensor:
        """The bucket's (b, w) int64 host buffer (pinned on a card); the
        previous request's copy out of it has ended, since every request
        ends in reading its logits back."""
        buf = self._staging.get((b, w))
        if buf is None:
            buf = torch.empty((b, w), dtype=torch.int64,
                              pin_memory=self.device.type == "cuda")
            self._staging[(b, w)] = buf
        return buf

    def __call__(self, subgraphs: List[Sequence[int]]) -> np.ndarray:
        """Returns (len(subgraphs), C) logits as numpy."""
        self._requests += 1
        with span("glass.serve.request", self._requests):
            with span("glass.serve.stage"):
                n = len(subgraphs)
                width = max((len(s) for s in subgraphs), default=1)
                b = _bucket(n, self.batch_buckets)
                w = _bucket(width, self.width_buckets)
                pos_t = self._host_pos(b, w)
                pos = pos_t.numpy()
                pos.fill(-1)
                for i, s in enumerate(subgraphs):
                    pos[i, : len(s)] = np.asarray(s, dtype=np.int64)
                if recording():
                    count("serve.nodes", sum(len(s) for s in subgraphs))
                    count("serve.slots", b * w)
            with span("glass.serve.launch"):
                logits = self._programs((b, w), self._forward, (pos_t,),
                                        self._stream if self._graphed
                                        else None)
            with span("glass.serve.readback"):
                return logits.cpu().numpy()[:n]

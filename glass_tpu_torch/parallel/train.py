"""Sharded training: data-parallel subgraph batches x a node-partitioned
graph (counterpart of ``glass_tpu/parallel/train.py``).

One process per rank of the ('data', 'graph') mesh (``parallel/mesh.py``).
Graph rank g holds node block g of the partitioned graph
(``parallel/partition.py``) and its rows of x; the shard-aware ops (the
halo all-gather or ring of ``ops/spmm.py``, the all-reduced GraphNorm
statistics) run the unchanged model on the block. Data rank d trains on
its slice of every subgraph batch; the zero-one labels are all-reduced
(max) over the data axis, so the whole batch shares one z, as the
reference's per-batch MaxZOZ (impl/utils.py:32-45).

Per step (``glass_tpu/parallel/train.py:201-249``): every graph rank
computes the same loss, so the head's gradients are whole on each, while
the trunk's arrive K-times scaled through the all-gather's backward (a
reduce-scatter of K equal cotangents); the mean over the graph axis is
exact for both. Then the mean over the data axis (data parallelism), and
the loss's mean over the data axis. Adam and the plateau schedule are the
:class:`~glass_tpu_torch.train.loop.Trainer`'s, and the parameters start
equal on every rank (one seed, and a broadcast from rank 0).

The steps run eagerly: a step whose collectives are NCCL's is not captured
into a CUDA graph here. Dropout masks are drawn for the whole graph from
one seed on every rank and sliced (``nn/dropout.py``), so a sharded run
draws the masks an unsharded one draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from glass_tpu_torch.ops.collectives import (all_gather_rows, all_reduce,
                                             broadcast_)
from glass_tpu_torch.ops.labeling import max_zero_one_local
from glass_tpu_torch.parallel.mesh import Mesh
from glass_tpu_torch.parallel.partition import PartitionedGraph
from glass_tpu_torch.train.loop import TrainConfig, Trainer
from glass_tpu_torch.train.metrics import device_metric_counts, score_from_counts


class ShardedTrainer(Trainer):
    """Sharded train and eval steps of one (model, partitioned graph) on
    this rank.

    ``x`` is the (N, C) integer node-feature array (host numpy); this rank
    keeps its node block's rows, padded. The batches' leading dim (B) must
    divide by the data axis's size; each data rank takes its contiguous
    B / D slice. The model's parameters lie on this rank's device, where
    its shard goes. The API is the :class:`Trainer`'s (``train_epoch``,
    ``train_epochs``, ``evaluate``, ``evaluate_score``, ...) plus JAX's
    ``train_step`` and ``eval_step``; eval logits and scores are whole-batch
    on every rank."""

    def __init__(self, model: torch.nn.Module, pgraph: PartitionedGraph, x,
                 cfg: TrainConfig, mesh: Mesh):
        self.mesh = mesh
        self.pg = pgraph
        device = next(model.parameters()).device
        graph, x_local = self._shard(pgraph, x, device)
        super().__init__(model, graph, x_local, cfg)
        self._graphed = False  # eager steps (module docstring)
        self._stream = None

    def _shard(self, pgraph: PartitionedGraph, x, device):
        """(this rank's Graph, its (nb, C) rows of x) on ``device``."""
        if pgraph.n_shards != self.mesh.graph_shards:
            raise ValueError(f"the graph is partitioned {pgraph.n_shards} "
                             f"ways; the mesh's graph axis has "
                             f"{self.mesh.graph_shards} ranks")
        k, nb = self.mesh.graph_rank, pgraph.block
        graph = pgraph.local_graph(k, self.mesh.graph_group, device)
        xl = pgraph.pad_nodes(np.asarray(x))[k * nb: (k + 1) * nb]
        return graph, torch.from_numpy(xl.astype(np.int64)).to(device)

    # ----------------------------------------------------------- internals

    def init(self, seed: int) -> None:
        """The :class:`Trainer`'s fresh state from ``seed``, and the
        parameters made equal to global rank 0's."""
        super().init(seed)
        if dist.is_initialized():
            for p in self.model.parameters():
                broadcast_(p.data, src=0)

    def _data_slice(self, a: torch.Tensor) -> torch.Tensor:
        """This data rank's contiguous slice of a batch's leading dim."""
        b = a.shape[0] // self.mesh.data_shards
        return a[self.mesh.data_rank * b: (self.mesh.data_rank + 1) * b]

    def _check_batch(self, pos) -> None:
        d = self.mesh.data_shards
        if pos.shape[0] % d != 0:
            raise ValueError(
                f"batch size {pos.shape[0]} does not divide the 'data' mesh "
                f"axis ({d} shards); pick a batch_size that is a multiple of "
                f"data_shards")

    def _z(self, pos: torch.Tensor) -> Optional[torch.Tensor]:
        """The labels of this data rank's slice on this node block, maxed
        over the data axis (``glass_tpu/parallel/train.py:219-223``)."""
        if not self.cfg.use_z:
            return None
        z = max_zero_one_local(pos, self.graph.n_node,
                               self.graph.node_offset())
        return all_reduce(z, self.mesh.data_group, "max")

    def _mean_over(self, t: torch.Tensor, group, n: int) -> torch.Tensor:
        return t if group is None else all_reduce(t, group) / n

    def _step(self, pos: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One step on this rank's slice of the batch (pos, y); the loss's
        mean over the data axis."""
        pos, y = self._data_slice(pos), self._data_slice(y)
        logits = self.model(self.graph, self.x, pos, self._z(pos),
                            training=True, generator=self.generator)
        loss = self.loss_fn(logits, y)
        loss.backward()
        params = list(self.model.parameters())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        m = self.mesh
        flat = self._mean_over(flat, m.graph_group, m.graph_shards)
        flat = self._mean_over(flat, m.data_group, m.data_shards)
        for p, g in zip(params, torch.split(flat, [p.numel()
                                                   for p in params])):
            p.grad = g.view_as(p)
        self.optimizer.step()
        return self._mean_over(loss.detach(), m.data_group, m.data_shards)

    def _local_logits(self, pos_b) -> torch.Tensor:
        """(nb, B / D, C) logits of this data rank's slices."""
        pos_b = self._to_device(pos_b)
        out = []
        with torch.no_grad():
            for pos in pos_b:
                pos = self._data_slice(pos)
                out.append(self.model(self.graph, self.x, pos, self._z(pos)))
        return torch.stack(out)

    def _eval_logits(self, pos_b) -> torch.Tensor:
        """(nb, B, C): the data ranks' slices gathered in batch order."""
        self._check_batch(pos_b[0])
        local = self._local_logits(pos_b)
        if self.mesh.data_group is None:
            return local
        whole = all_gather_rows(local.transpose(0, 1).contiguous(),
                                self.mesh.data_group)
        return whole.transpose(0, 1)

    # ------------------------------------------------------------- public

    def train_step(self, pos, y) -> float:
        """One step on a (B, L) batch at the plateau's learning rate (the
        schedule does not advance); the loss."""
        self._check_batch(pos)
        self._apply_lr()
        self.optimizer.zero_grad(set_to_none=True)
        return float(self._step(self._to_device(pos), self._to_device(y)))

    def eval_step(self, pos) -> torch.Tensor:
        """(B, C) logits of one batch."""
        return self._eval_logits(np.asarray(pos)[None])[0]

    def train_epoch(self, pos_b, y_b):
        self._check_batch(pos_b[0])
        return super().train_epoch(pos_b, y_b)

    def train_epochs(self, pos_bs, y_bs) -> np.ndarray:
        self._check_batch(pos_bs[0][0])
        return super().train_epochs(pos_bs, y_bs)

    def evaluate_score(self, pos_b, y_pad, mask) -> float:
        """Micro-F1 from this data rank's counts, summed over the data axis
        (``glass_tpu/parallel/train.py:329-338``)."""
        self._check_batch(pos_b[0])
        counts = device_metric_counts(
            self._local_logits(pos_b),
            self._data_slice(self._to_device(y_pad).transpose(0, 1))
            .transpose(0, 1),
            self._data_slice(self._to_device(mask).transpose(0, 1))
            .transpose(0, 1),
            self.cfg.loss == "bce")
        if self.mesh.data_group is not None:
            counts = all_reduce(counts, self.mesh.data_group)
        return score_from_counts(counts.cpu().numpy())

"""Sharded training of a whole-graph :class:`Graph` (counterpart of
``glass_tpu/parallel/auto.py``, the GSPMD mode).

JAX annotates the batch dim over 'data' and, on a mesh with a 'graph' axis,
the dense adjacency's rows over 'graph', and lets XLA partition the same
program. PyTorch has no such partitioner, so this computes the same thing
explicitly through :class:`~glass_tpu_torch.parallel.train.ShardedTrainer`:

- each data rank trains on its slice of every batch, and the gradients are
  averaged over the data axis;
- with graph_shards > 1, the dense adjacency's rows are split over the
  graph axis: graph rank k keeps rows [k*nb, (k+1)*nb) (padded, with
  K*nb columns) and runs the dense SpMM on the all-gathered features. A
  graph with no dense layout raises, as in JAX: block-sparse layouts are
  not partitioned here (partition them with ``partition_graph`` for the
  ShardedTrainer).
"""

from __future__ import annotations

import numpy as np
import torch

from glass_tpu_torch.ops.graph import Graph
from glass_tpu_torch.parallel.mesh import Mesh
from glass_tpu_torch.parallel.train import ShardedTrainer
from glass_tpu_torch.train.loop import TrainConfig


class AutoTrainer(ShardedTrainer):
    """A :class:`ShardedTrainer` over a whole-graph ``graph`` (from
    ``build_graph``, on this rank's device): the graph as it is with one
    graph rank, its dense rows split over several. ``x``: the (N, C)
    integer features, a tensor or host array."""

    def __init__(self, model: torch.nn.Module, graph: Graph, x,
                 cfg: TrainConfig, mesh: Mesh):
        if mesh.graph_shards > 1 and graph.dense is None:
            raise ValueError(
                "graph sharding with sharding='auto' splits the dense "
                "whole-graph SpMM's rows; this graph has no dense layout "
                "(block-sparse layouts cannot be auto-partitioned: use "
                "partition_graph and the ShardedTrainer for those)")
        super().__init__(model, graph, x, cfg, mesh)

    def _shard(self, graph: Graph, x, device):
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        if self.mesh.graph_shards == 1:
            return graph, torch.from_numpy(x.astype(np.int64)).to(device)
        n, k = graph.n_node, self.mesh.graph_shards
        g, nb = self.mesh.graph_rank, -(-n // k)
        lo, hi = g * nb, min((g + 1) * nb, n)
        dense = graph.dense.new_zeros((nb, k * nb))
        dense[: hi - lo, :n] = graph.dense[lo:hi]
        sel = (graph.row >= lo) & (graph.row < hi) & (graph.weight != 0)
        local = Graph(
            row=graph.row[sel] - lo, col=graph.col[sel],
            weight=graph.weight[sel], dense=dense, n_node=nb,
            n_edge=graph.n_edge, aggr=graph.aggr,
            axis=self.mesh.graph_group, n_node_global=n)
        xl = np.pad(x, [(0, k * nb - n)] + [(0, 0)] * (x.ndim - 1))
        return local, torch.from_numpy(
            xl[lo: lo + nb].astype(np.int64)).to(device)

"""Segregated-subgraph data for the GNN-seg baseline (counterpart of
``glass_tpu/data/seg.py``).

The reference extracts each subgraph as its own small graph
(k_hop_subgraph(hop=0), the induced subgraph, GNNSeg.py:213-249) and
batches them with PyG collation. Here, as in the JAX package, subgraphs
are padded to one width L and held as dense per-subgraph adjacencies
(S, L, L), dense features (S, L, F) and node-validity masks (S, L), so
message passing is one batched product a layer.

Features (GNNSeg.py:235-241): real-world datasets take the one-hot global
degree (datasets.py:30-37 addDegreeFeature), synthetics all ones
(datasets.py:39-43 addOneFeature), gathered from the *full* graph's
features for each subgraph's nodes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from glass_tpu_torch import native
from glass_tpu_torch.data.basegraph import BaseGraphData
from glass_tpu_torch.ops.graph import degrees


@dataclasses.dataclass
class SegData:
    """feats: (S, L, F); adj_norm: (S, L, L) GCN-normalized; adj_sum:
    (S, L, L) unnormalized; mask: (S, L) valid nodes; y: labels."""

    feats: np.ndarray
    adj_norm: np.ndarray
    adj_sum: np.ndarray
    mask: np.ndarray
    y: np.ndarray


def global_features(base: BaseGraphData, kind: str) -> np.ndarray:
    """(N, F) dense f32 features of the full graph: "one" (all ones, F = 1)
    or "deg" (the one-hot degree, F = max degree + 1)."""
    n = base.n_node
    if kind == "one":
        return np.ones((n, 1), dtype=np.float32)
    if kind == "deg":
        deg = degrees(base.edge_index, base.edge_weight, n).astype(np.int64)
        f = np.zeros((n, deg.max() + 1), dtype=np.float32)
        f[np.arange(n), deg] = 1.0
        return f
    raise NotImplementedError(kind)


def _induced_adj_numpy(base: BaseGraphData, pos: np.ndarray, L: int) -> np.ndarray:
    """The native ``induced_subgraph_adj``'s numpy branch: 1.0 per distinct
    directed edge between members (O(S * L^2) in Python)."""
    n = base.n_node
    ekeys = set(base.edge_index[0].astype(np.int64) * n
                + base.edge_index[1].astype(np.int64))
    S = pos.shape[0]
    adj = np.zeros((S, L, L), dtype=np.float32)
    for i in range(S):
        nodes = pos[i][pos[i] >= 0]
        for j, v in enumerate(nodes):
            for jj, w in enumerate(nodes):
                if int(v) * n + int(w) in ekeys:
                    adj[i, j, jj] += 1.0
    return adj


def segregate(base: BaseGraphData, feature_kind: str) -> dict:
    """SegData for each split ("train", "valid", "test"). L is the largest
    subgraph over the whole dataset, so every split has one shape. The
    induced adjacencies come from the native host library, else from
    numpy (``base``'s edges are deduplicated, so both give the same
    arrays)."""
    feats_full = global_features(base, feature_kind)
    L = int((base.pos >= 0).sum(axis=1).max())
    out = {}
    for split in ("train", "valid", "test"):
        pos, y = base.get_split(split)
        S = pos.shape[0]
        F = feats_full.shape[1]
        pos_w = np.full((S, L), -1, dtype=np.int64)
        pos_w[:, : pos.shape[1]] = pos[:, :L]
        adj_s = native.induced_subgraph_adj(base.edge_index, base.n_node, pos_w)
        if adj_s is None:
            adj_s = _induced_adj_numpy(base, pos_w, L)
        feats = np.zeros((S, L, F), dtype=np.float32)
        mask = np.zeros((S, L), dtype=bool)
        for i in range(S):
            nodes = pos_w[i][pos_w[i] >= 0]
            mask[i, : len(nodes)] = True
            feats[i, : len(nodes)] = feats_full[nodes]
        # PyG gcn_norm without self-loops: D^-1/2 A D^-1/2, 0-degree rows
        # 0 (GNNSeg.py:267-268 add_self_loops=False)
        deg = adj_s.sum(axis=2)
        dis = np.where(deg > 0, deg, 1.0) ** -0.5
        dis = np.where(deg > 0, dis, 0.0)
        adj_n = dis[:, :, None] * adj_s * dis[:, None, :]
        out[split] = SegData(feats=feats, adj_norm=adj_n.astype(np.float32),
                             adj_sum=adj_s, mask=mask, y=y)
    return out

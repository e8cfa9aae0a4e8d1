"""Host-side k-hop subgraph extraction (counterpart of
``glass_tpu/data/khop.py``; reference substrate: PyG ``k_hop_subgraph``,
used by GNN-seg at GNNSeg.py:214-218 with hop=0).

hop=0 returns the induced subgraph on the seed nodes; hop=k expands the node
set by k BFS levels first. Pure numpy/CSR — data-prep time only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _csr(edge_index: np.ndarray, n_node: int):
    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    order = np.argsort(row, kind="stable")
    row_s, col_s = row[order], col[order]
    ptr = np.zeros(n_node + 1, dtype=np.int64)
    np.add.at(ptr, row_s + 1, 1)
    return np.cumsum(ptr), col_s


def k_hop_subgraph(
    seed_nodes: np.ndarray,
    num_hops: int,
    edge_index: np.ndarray,
    n_node: int,
    relabel_nodes: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (nodes, sub_edge_index, seed_positions, edge_mask) like the
    reference substrate: ``nodes`` is the expanded node set, ``sub_edge_index``
    the induced edges (relabeled when requested), ``seed_positions`` the
    indices of the seeds within ``nodes``, ``edge_mask`` the kept-edge mask."""
    ptr, col_s = _csr(edge_index, n_node)
    in_set = np.zeros(n_node, dtype=bool)
    seed_nodes = np.asarray(seed_nodes, dtype=np.int64)
    in_set[seed_nodes] = True
    frontier = seed_nodes
    for _ in range(num_hops):
        nxt = []
        for u in frontier:
            nbrs = col_s[ptr[u]: ptr[u + 1]]
            nxt.append(nbrs[~in_set[nbrs]])
        if not nxt:
            break
        frontier = np.unique(np.concatenate(nxt))
        if frontier.size == 0:
            break
        in_set[frontier] = True

    nodes = np.flatnonzero(in_set)
    edge_mask = in_set[edge_index[0]] & in_set[edge_index[1]]
    sub = edge_index[:, edge_mask]
    if relabel_nodes:
        local = np.full(n_node, -1, dtype=np.int64)
        local[nodes] = np.arange(nodes.shape[0])
        sub = local[sub]
        seed_pos = local[seed_nodes]
    else:
        seed_pos = seed_nodes
    return nodes, sub, seed_pos, edge_mask

"""Host-side dataset container (numpy) and feature initializers
(counterpart of ``glass_tpu/data/basegraph.py``).

Conventions kept from the reference (datasets.py):
- ``pos`` is the padded subgraph-node matrix, pad = -1;
- ``mask[i]`` in {0, 1, 2} = train/valid/test;
- the graph is stored undirected: both edge directions present, duplicates
  coalesced by ``undirect`` when the input was not already undirected.

``get_lp_dataset`` (SSL link prediction) is ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from glass_tpu_torch.ops.graph import degrees


def undirect(edge_index: np.ndarray) -> np.ndarray:
    """Symmetrize + coalesce an edge list (dedup, sorted): PyG
    ``to_undirected`` as used at datasets.py:68-71."""
    both = np.concatenate([edge_index, edge_index[::-1]], axis=1)
    pairs = np.unique(both.T, axis=0)
    return pairs.T.copy()


def _sorted_set(keys: np.ndarray) -> np.ndarray:
    """The distinct values of ``keys``, ascending, by one sort (numpy's
    ``unique`` may hash integers, which is slower at 9M keys)."""
    keys = np.sort(keys)
    return keys[np.concatenate([[True], keys[1:] != keys[:-1]])]


def is_undirected(edge_index: np.ndarray) -> bool:
    """True when every edge (r, c) has its reverse (c, r) among the edges.
    The JAX package builds a Python set of every edge
    (``glass_tpu/data/basegraph.py:33-35``); this answers the same question
    with sorted int64 keys, so 9M edges take a second, not GBs: the set of
    reversed edges has as many members as the set of edges, so it lies in
    that set exactly when the two are equal."""
    ei = np.asarray(edge_index, dtype=np.int64)
    if ei.shape[1] == 0:
        return True
    lo = int(ei.min())
    r, c = ei[0] - lo, ei[1] - lo
    span = int(max(r.max(), c.max())) + 1
    return bool(np.array_equal(_sorted_set(r * span + c),
                               _sorted_set(c * span + r)))


def relabel_pos(pos: np.ndarray, perm: np.ndarray, n_node: int) -> np.ndarray:
    """Maps a padded subgraph matrix (pad = -1) into the relabeled node
    space of ``relabel_nodes`` (perm[i] = old id at new position i)."""
    inv = np.empty(n_node, dtype=np.int64)
    inv[perm] = np.arange(n_node)
    return np.where(pos >= 0, inv[np.clip(pos, 0, n_node - 1)], -1)


@dataclasses.dataclass
class BaseGraphData:
    """x: (N, C) int node features (C = 1); edge_index: (2, E) undirected;
    edge_weight: (E,); pos: (S, L) padded; y: (S,) or (S, K); mask: (S,)."""

    x: np.ndarray
    edge_index: np.ndarray
    edge_weight: np.ndarray
    pos: np.ndarray
    y: np.ndarray
    mask: np.ndarray

    def __post_init__(self):
        if not is_undirected(self.edge_index):
            self.edge_index = undirect(self.edge_index)
            self.edge_weight = np.ones(self.edge_index.shape[1], dtype=np.float32)

    @property
    def n_node(self) -> int:
        return self.x.shape[0]

    @property
    def binary(self) -> bool:
        """True when the task is binary or multilabel (the BCE path): the
        reference picks the loss by label arity (GLASSTest.py:55-71)."""
        return np.unique(self.y).shape[0] == 2

    @property
    def output_channels(self) -> int:
        if self.binary:
            return self.y.shape[1] if self.y.ndim > 1 else 1
        return int(np.unique(self.y).shape[0])

    @property
    def max_deg(self) -> int:
        return int(self.x.max())

    # ------------------------------------------------- feature initializers

    def set_one_feature(self):
        """Homogeneous integer feature (reference: datasets.py:54-56)."""
        self.x = np.ones((self.n_node, 1), dtype=np.int64)

    def set_degree_feature(self, mod: int = 1):
        """Bucketized node degree (reference: datasets.py:45-52): floor-divide
        by mod then re-index by unique value rank."""
        deg = degrees(self.edge_index, self.edge_weight, self.n_node).astype(np.int64)
        deg = deg // mod
        _, inv = np.unique(deg, return_inverse=True)
        self.x = inv.reshape(self.n_node, 1).astype(np.int64)

    def set_node_id_feature(self):
        """Node index as feature: the row of a (pretrained) embedding table
        (reference: datasets.py:58-61)."""
        self.x = np.arange(self.n_node, dtype=np.int64).reshape(self.n_node, 1)

    def relabel_nodes(self, perm: np.ndarray) -> None:
        """Applies a node relabeling (perm[i] = old id at new position i) to
        edges, subgraph node sets and per-node features (used with the RCM
        ordering, ``native.rcm_ordering``); predictions are invariant
        under relabeling."""
        n = self.n_node
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        self.edge_index = inv[self.edge_index]
        self.pos = relabel_pos(self.pos, perm, n)
        self.x = self.x[perm]

    # -------------------------------------------------------------- splits

    def get_split(self, split: str) -> Tuple[np.ndarray, np.ndarray]:
        tar = {"train": 0, "valid": 1, "test": 2}[split]
        sel = self.mask == tar
        return self.pos[sel], self.y[sel]

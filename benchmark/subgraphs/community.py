"""Subgraphs of ``min_nodes``-``max_nodes`` nodes, each drawn without
replacement from 1-``max_communities`` neighbouring communities of a
clustered graph (``chip_smoke.py::make_request``'s recipe)."""

import numpy as np


def draw(rng: np.random.Generator, count: int, spec: dict, graph: dict):
    n, csz = graph["nodes"], graph["community_size"]
    n_comm = -(-n // csz)
    lo, hi = spec["min_nodes"], spec["max_nodes"]
    most = spec["max_communities"]
    subs = []
    for _ in range(count):
        k = int(rng.integers(1, most + 1))
        c0 = int(rng.integers(0, n_comm - k + 1))
        span = min(k * csz, n - c0 * csz)
        size = min(int(rng.integers(lo, hi + 1)), span)
        subs.append(c0 * csz + rng.choice(span, size, replace=False))
    return subs

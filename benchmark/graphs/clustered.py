"""A clustered stand-in (``tools/torch_max_scale.py::clustered_graph``'s
recipe, drawn without repeats): ``nodes`` nodes in communities of
``community_size`` along a chain, the last taking what is left, and
``undirected_edges`` distinct edges with no self-loop, ``intra_frac`` of
them inside a community and the rest between chain-neighbouring ones,
each edge both ways."""

import numpy as np

from benchmark.generate import both_ways, distinct_slots


def make(spec: dict, seed: int):
    n, csz, e = spec["nodes"], spec["community_size"], spec["undirected_edges"]
    n_comm = -(-n // csz)
    intra = int(spec["intra_frac"] * e)
    rng = np.random.default_rng(seed)
    # a slot is (community c, a, b): the edge (c csz + a, c' csz + b)

    def inside(m):  # c' = c, a < b
        c = rng.integers(0, n_comm, m)
        x, y = rng.integers(0, csz, m), rng.integers(0, csz, m)
        a, b = np.minimum(x, y), np.maximum(x, y)
        ok = (a < b) & (c * csz + b < n)
        return (c * csz + a)[ok] * csz + b[ok]

    def between(m):  # c' = c + 1
        c = rng.integers(0, n_comm - 1, m)
        a, b = rng.integers(0, csz, m), rng.integers(0, csz, m)
        ok = (c + 1) * csz + b < n
        return (c * csz + a)[ok] * csz + b[ok]

    universe = n_comm * csz * csz
    s1 = distinct_slots(rng, inside, intra, universe)
    s2 = distinct_slots(rng, between, e - intra, universe)
    u1 = s1 // csz
    u2 = s2 // csz
    v1 = u1 // csz * csz + s1 % csz
    v2 = (u2 // csz + 1) * csz + s2 % csz
    return both_ways(np.concatenate([u1, u2]), np.concatenate([v1, v2])), n

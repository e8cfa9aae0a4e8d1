"""A uniform stand-in (``chip_smoke.py::hpo_graph``'s recipe, drawn without
repeats): ``undirected_edges`` distinct edges with no self-loop whose
endpoints are uniform over ``nodes`` nodes, each edge both ways."""

import numpy as np

from benchmark.generate import both_ways, distinct_slots


def make(spec: dict, seed: int):
    n = spec["nodes"]
    rng = np.random.default_rng(seed)

    def draw(m):  # a slot is u n + v, u < v
        x, y = rng.integers(0, n, m), rng.integers(0, n, m)
        a, b = np.minimum(x, y), np.maximum(x, y)
        ok = a < b
        return a[ok] * n + b[ok]

    s = distinct_slots(rng, draw, spec["undirected_edges"], n * n)
    return both_ways(s // n, s % n), n

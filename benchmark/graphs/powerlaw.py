"""A degree-skewed stand-in (Chung and Lu's model, drawn without repeats):
``undirected_edges`` distinct edges with no self-loop over ``nodes``
nodes, each endpoint drawn with probability proportional to the weight
``w_i = (i + 1) ** (-1 / (exponent - 1))``, scaled to a sum of twice the
edges (each node's expected degree) and capped at the square root of that
sum, so that no pair's expected count passes one; each edge both ways,
and the node ids permuted by the seed."""

import numpy as np

from benchmark.generate import both_ways, distinct_slots


def weights(n: int, e: int, exponent: float) -> np.ndarray:
    """The capped Chung-Lu weights of ``n`` nodes and ``e`` edges, in
    ascending id order before the permutation (node 0 the largest)."""
    w = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (exponent - 1.0))
    w *= 2.0 * e / w.sum()
    return np.minimum(w, np.sqrt(2.0 * e))


def make(spec: dict, seed: int):
    n, e = spec["nodes"], spec["undirected_edges"]
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(weights(n, e, spec["exponent"]))
    cdf /= cdf[-1]

    def endpoint(m):
        return np.minimum(np.searchsorted(cdf, rng.random(m), side="right"),
                          n - 1)

    def draw(m):  # a slot is u n + v, u < v
        x, y = endpoint(m), endpoint(m)
        a, b = np.minimum(x, y), np.maximum(x, y)
        ok = a < b
        return a[ok] * n + b[ok]

    s = distinct_slots(rng, draw, e, n * n)
    perm = rng.permutation(n)
    return both_ways(perm[s // n], perm[s % n]), n

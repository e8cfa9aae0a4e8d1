"""Subgraphs whose sizes follow a lognormal of the published mean
``mean_nodes`` and standard deviation ``sd_nodes`` (sigma^2 = ln(1 +
sd^2 / mean^2), mu = ln(mean) - sigma^2 / 2), rounded and clipped to
``min_nodes``-``max_nodes``; each one's nodes uniform over the graph,
without replacement.

The sizes are the lognormal's quantiles at (i + 1/2) / count, dealt out in
an order drawn from the seed: a published data set is one fixed set of
subgraphs, whose sizes do not change from one run to the next. Sizes drawn
afresh would give each seed another largest subgraph (76-128 nodes over
1,272 draws), and with it another padded width for every batch."""

from statistics import NormalDist

import numpy as np


def params(mean: float, sd: float):
    """(mu, sigma) of the lognormal with this mean and deviation."""
    var = np.log1p((sd / mean) ** 2)
    return float(np.log(mean) - var / 2), float(np.sqrt(var))


def sizes(rng: np.random.Generator, count: int, spec: dict) -> np.ndarray:
    mu, sigma = params(spec["mean_nodes"], spec["sd_nodes"])
    z = np.array([NormalDist().inv_cdf((i + 0.5) / count)
                  for i in range(count)])
    k = np.clip(np.rint(np.exp(mu + sigma * z)), spec["min_nodes"],
                spec["max_nodes"]).astype(np.int64)
    return rng.permutation(k)


def draw(rng: np.random.Generator, count: int, spec: dict, graph: dict):
    return [rng.choice(graph["nodes"], int(k), replace=False)
            for k in sizes(rng, count, spec)]

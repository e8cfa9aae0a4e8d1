"""Subgraphs of ``min_nodes``-``max_nodes`` nodes, uniform over the graph
(``chip_smoke.py::class_labelled_subgraphs``'s recipe)."""

import numpy as np


def draw(rng: np.random.Generator, count: int, spec: dict, graph: dict):
    return [rng.choice(graph["nodes"], int(k), replace=False)
            for k in rng.integers(spec["min_nodes"], spec["max_nodes"] + 1,
                                  count)]

"""Inputs made from the seed: stand-in graphs, feature ids, subgraphs,
labels and initial weights. The same seed gives the same inputs, which
the benchmark hands to the program and to the plain reference alike.

A configuration's graph and subgraph draws name their recipe by ``kind``:
``benchmark/graphs/<kind>.py`` (a ``make(spec, seed)``) and
``benchmark/subgraphs/<kind>.py`` (a ``draw(rng, count, spec, graph)``),
found by name, so that a new recipe is a file added. The recipes are
copies, kept here so that a later change to the program cannot move the
yardstick; ``degree_ids`` is ``chip_smoke.py::degree_features`` (the rank
of a node's degree among the unique degrees).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark import byname

BENCH = Path(__file__).resolve().parent


def sub_seed(seed: int, stream: int) -> int:
    """A 32-bit seed for one stream of draws of a run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), stream])
    return int(ss.generate_state(1, np.uint32)[0])


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


# streams of a run's seed
GRAPH, SUBGRAPHS, SHUFFLE, WEIGHTS, DROPOUT, REQUESTS, SAMPLE = range(7)


def distinct_slots(rng: np.random.Generator,
                   draw: Callable[[int], np.ndarray], count: int,
                   universe: int) -> np.ndarray:
    """``count`` distinct slots of ``range(universe)``, sorted: ``draw(m)``
    gives up to m candidate slots a call, and is called until they hold
    ``count`` distinct ones; ``rng`` then keeps ``count`` of those, each as
    likely as another. Marks a table of the universe, so no sort."""
    seen = np.zeros(universe, dtype=bool)
    drawn, want = 0, count
    while True:
        slots = draw(want + 1024)
        seen[slots] = True
        drawn += slots.size
        have = int(np.count_nonzero(seen))
        if have >= count:
            break
        # more draws for what is missing, at the repeat rate seen so far
        want = int((count - have) * 2 * drawn / max(have, 1))
    slots = np.flatnonzero(seen)
    del seen
    if slots.size > count:
        keep = np.ones(slots.size, dtype=bool)
        keep[rng.choice(slots.size, slots.size - count, replace=False,
                        shuffle=False)] = False
        slots = slots[keep]
    return slots


def both_ways(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(2, 2e) int64 directed edges, each undirected edge both ways."""
    return np.stack([np.concatenate([u, v]), np.concatenate([v, u])])


def make_graph(spec: dict, seed: int, bench: Path = BENCH
               ) -> Tuple[np.ndarray, int]:
    """The configuration's stand-in graph, drawn from the run's seed by the
    recipe ``benchmark/graphs/<kind>.py``."""
    recipe = byname.load(bench / "graphs", spec["kind"])
    return recipe.make(spec, sub_seed(seed, GRAPH))


def degree_ids(ei: np.ndarray, n: int) -> np.ndarray:
    """(n, 1) int64 degree-bucket feature ids: the rank of each node's
    (row) degree among the unique degrees."""
    deg = np.bincount(ei[0], minlength=n)
    _, inv = np.unique(deg, return_inverse=True)
    return inv.reshape(n, 1).astype(np.int64)


def draw_subgraphs(rng: np.random.Generator, count: int, spec: dict,
                   graph: dict, bench: Path = BENCH) -> List[np.ndarray]:
    """``count`` subgraphs drawn on the configuration's ``graph`` by the
    recipe ``benchmark/subgraphs/<kind>.py`` its ``subgraphs`` section
    names."""
    recipe = byname.load(bench / "subgraphs", spec["kind"])
    return recipe.draw(rng, count, spec, graph)


def pad(subs: Sequence[np.ndarray], width: int = 0) -> np.ndarray:
    """(len(subs), max(width, longest)) int64, padded with -1."""
    width = max(width, max(len(s) for s in subs))
    pos = np.full((len(subs), width), -1, dtype=np.int64)
    for i, s in enumerate(subs):
        pos[i, : len(s)] = s
    return pos


def size_labels(sizes: np.ndarray, classes: int) -> np.ndarray:
    """Labels by size: 2 classes, float 1 iff above the median (a BCE
    target); more, int64 quantile bins of equal count."""
    if classes == 2:
        return (sizes > np.median(sizes)).astype(np.float32)
    edges = np.quantile(sizes, np.linspace(0, 1, classes + 1)[1:-1])
    return np.digitize(sizes, edges).astype(np.int64)


def train_split(spec: dict, graph: dict, seed: int, bench: Path = BENCH):
    """(pos (S, L) int64, y (S,)) of the configuration's train split."""
    rng = rng_for(seed, SUBGRAPHS)
    count = int(spec["count"] * spec["train_share"])
    subs = draw_subgraphs(rng, count, spec, graph, bench)
    sizes = np.array([len(s) for s in subs])
    return pad(subs), size_labels(sizes, spec["classes"])


def make_weights(shapes: Dict[str, Tuple[Tuple[int, ...], str]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The initial f32 parameters, drawn on ``device`` from the seed in two
    calls (one uniform, one normal vector) and sliced per leaf:
    ``linear`` weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as
    torch's Linear, ``embedding`` N(0, 1), and GraphNorm's vectors around
    their init (``norm_one``: 1 + 0.1 N, ``norm_zero``: 0.1 N) so that each
    of them shows in the comparison. ``shapes`` maps a name to (shape,
    kind); a linear leaf's fan-in is its weight's last size."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    n_u = sum(int(np.prod(s)) for s, k in shapes.values()
              if k.startswith("linear"))
    n_n = sum(int(np.prod(s)) for s, k in shapes.values()
              if not k.startswith("linear"))
    u = torch.rand(n_u, generator=gen, device=device) * 2 - 1
    z = torch.randn(n_n, generator=gen, device=device)
    out, iu, iz = {}, 0, 0
    for name, (shape, kind) in shapes.items():
        size = int(np.prod(shape))
        if kind.startswith("linear"):
            fan_in = int(kind.split(":")[1])
            out[name] = (u[iu: iu + size] / np.sqrt(fan_in)).reshape(shape)
            iu += size
            continue
        v = z[iz: iz + size].reshape(shape)
        iz += size
        if kind == "embedding":
            out[name] = v
        elif kind == "norm_one":
            out[name] = 1 + 0.1 * v
        elif kind == "norm_zero":
            out[name] = 0.1 * v
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
    return {k: v.contiguous() for k, v in out.items()}

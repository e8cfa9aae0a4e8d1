"""A closed loop into ``Predictor.__call__`` at its default buckets: one
caller, no think time, each request sent as the one before it returns,
from a pool drawn in set-up and cycled. A request's subgraph count is
drawn from the traffic's bands, a fixed set of counts in an order of the
seed, and its subgraphs as the configuration draws them. Set-up captures
the buckets the pool reaches and no others. A latency runs from the call
into ``Predictor`` to the logits on the host. Every request's logits are
kept; after the window a sample of them (the largest requests served and
a draw of the seed) is held against the reference.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from glass_tpu_torch import Predictor

from benchmark import cells
from benchmark import generate as gen
from benchmark import trace as tr
from benchmark.compare import serve_numbers


def band_counts(bands: List[list], pool: int) -> np.ndarray:
    """A pool's subgraph counts a request: each band [lo, hi, share] gets
    round(share * pool) requests, spread evenly over lo..hi (the first
    band takes the rounding); the same set for every seed."""
    counts = []
    for lo, hi, share in bands[1:]:
        c = int(round(share * pool))
        counts.append(lo + ((np.arange(c) + 0.5) * (hi - lo + 1) / c)
                      .astype(np.int64))
    lo, hi, _ = bands[0]
    c = pool - sum(len(a) for a in counts)
    counts.insert(0, lo + ((np.arange(c) + 0.5) * (hi - lo + 1) / c)
                  .astype(np.int64))
    return np.concatenate(counts)


def bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


class Driver(cells.Cell):
    mode = "serve"

    def setup(self, seed: int) -> None:
        self.make_inputs(seed)
        rng = gen.rng_for(seed, gen.REQUESTS)
        counts = rng.permutation(band_counts(self.traffic["bands"],
                                             self.traffic["pool"]))
        subs = self.draw_subgraphs(rng, int(counts.sum()))
        ends = np.cumsum(counts)
        self.pool = [subs[e - c: e] for c, e in zip(counts, ends)]
        self.pool_nodes = [sum(len(s) for s in req) for req in self.pool]
        self.mark("pool")
        graph, x, model = self.build_model()
        pred = Predictor(model, graph, x,
                         use_z=self.model_cfg["use_maxzeroone"],
                         device=self.device)
        self.program = pred
        first = {}
        for i, req in enumerate(self.pool):
            key = (bucket(len(req), pred.batch_buckets),
                   bucket(max(len(s) for s in req), pred.width_buckets))
            first.setdefault(key, i)
        self.buckets = sorted(first)
        for i in first.values():  # the capture, then a replay
            pred(self.pool[i])
            pred(self.pool[i])
        cells.sync(self.device)
        self.mark("warm")

    def window(self, seconds: float) -> dict:
        """Requests back to back until ``seconds`` have passed."""
        lat, outs = [], []
        pool, pred = self.pool, self.program
        subgraphs = nodes = bad = 0
        t0 = time.perf_counter()
        with tr.span("window"):
            while True:
                i = len(lat)
                req = pool[i % len(pool)]
                start = time.perf_counter()
                with tr.span("request"):
                    out = pred(req)
                done = time.perf_counter()
                lat.append(done - start)
                outs.append(out)
                subgraphs += len(req)
                nodes += self.pool_nodes[i % len(pool)]
                bad += int(not np.isfinite(out).all())
                if done - t0 >= seconds:
                    break
        self.outputs = outs
        return dict(seconds=time.perf_counter() - t0, attempted=len(lat),
                    failed=bad, requests=len(lat), subgraphs=subgraphs,
                    pooled_nodes=nodes, latencies=lat)

    def sample(self, served: int) -> List[int]:
        """Indices of served requests to check: the largest pool requests
        served (an eighth of the sample) and a draw of the seed."""
        k = min(self.traffic["check_requests"], served)
        seen = min(served, len(self.pool))
        sizes = np.array([len(self.pool[i]) for i in range(seen)])
        top = list(np.argsort(-sizes, kind="stable")[: max(1, k // 8)])
        rng = gen.rng_for(self.seed, gen.SAMPLE)
        taken = {int(t) for t in top}
        rest = [i for i in rng.permutation(served)
                if i % len(self.pool) not in taken][: k - len(top)]
        return sorted(int(i) for i in top + rest)

    def after_window(self) -> None:
        """Keeps the sampled requests' served logits; drops the rest."""
        self.picked = self.sample(len(self.outputs))
        self.prog_logits = [self.outputs[i] for i in self.picked]
        self.outputs = None

    def reference_logits(self, indices: List[int], tf32: bool = False
                         ) -> List[np.ndarray]:
        adj = self.reference_adjacency()
        ids = torch.from_numpy(self.ids).to(self.device)
        out = []
        with self.ref.precision(tf32):
            for i in indices:
                pos = torch.from_numpy(gen.pad(self.pool[i % len(self.pool)])
                                       ).to(self.device)
                out.append(self.ref.predict(self.weights, self.model_cfg,
                                            adj, ids, pos).cpu().numpy())
        return out

    def numbers(self, tf32: bool = False) -> Dict[str, float]:
        return serve_numbers(self.prog_logits,
                             self.reference_logits(self.picked, tf32))

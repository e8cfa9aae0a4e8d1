#!/usr/bin/env python3
"""Where a GLASS serving request's and an evaluation's time goes in the
PyTorch/H100 port, graphed (the captured program of the bucket or eval
shape, replayed) beside eager (``_graphed`` cleared).

Builds the em_user-configuration model and stand-in graph of chip_smoke.py
(BCSR f32, the planner's layout there) on one CUDA card, then:
  1. times requests of 1, 6 and 64 subgraphs through Predictor on the host
     clock (each ends in a device-to-host copy of the logits, so the clock
     covers the device work), graphed and eager in turns, median and max
     over ``--repeats`` requests (every bucket met is captured first);
  2. traces ``--repeats`` requests of 6 subgraphs with torch.profiler, each
     way, and prints device time by kernel and device time per request.
     The wall time under the trace includes the profiler's own cost, so
     the card's idle share is taken against the untraced medians of 1;
  3. times Trainer.evaluate_score of a 60-subgraph val and test split
     (chip_smoke.py's stand-in splits, batch 6, the last batch padded)
     graphed and eager, median over ``--repeats``, and its device time.
Prints one JSON line per result. Run from the repository root:

    python3 tools/torch_serve_profile.py [--repeats 20]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402  (the stand-in graph, model and requests)
from glass_tpu_torch import (Predictor, TrainConfig, Trainer,  # noqa: E402
                             build_graph, make_eval_batches)
from glass_tpu_torch.train.metrics import pad_eval_labels  # noqa: E402

WAYS = {"graphed": True, "eager": False}


def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def profile(fn, calls: int) -> tuple:
    """(device ms a call, the top kernels' device µs a call) of ``calls``
    calls under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return (sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
            [[e.key, e.self_device_time_total / calls] for e in top])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--seed", type=int, default=4, help="request sampling seed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(json.dumps({"card": cs.card_line()}), flush=True)

    ei, n = cs.clustered_graph()
    graph = build_graph(ei, None, n, cs.EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="bcsr", device=device)
    feats_np = cs.degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    model = cs.em_user_model(int(feats_np.max()), "pallas", device)
    pred = Predictor(model, graph, feats, device=device)
    rng = np.random.default_rng(args.seed)
    median_ms = {}
    for batch in cs.REQUEST_BATCHES:
        reqs = [cs.make_request(rng, batch, cs.N_COMM, cs.COMM_SIZE)
                for _ in range(args.repeats)]
        for graphed in WAYS.values():  # every bucket's capture, warm-up
            pred._graphed = graphed
            for r in reqs:
                pred(r)
        ms = {way: [] for way in WAYS}
        for r in reqs:
            for way, graphed in WAYS.items():
                pred._graphed = graphed
                ms[way].append(host_ms(lambda: pred(r)))
        median_ms[batch] = {way: statistics.median(v) for way, v in ms.items()}
        print(json.dumps({"request_batch": batch, "n": len(reqs),
                          **{f"{way}_median_ms": median_ms[batch][way]
                             for way in WAYS},
                          **{f"{way}_max_ms": max(ms[way]) for way in WAYS}}),
              flush=True)

    batch = cs.EM_USER["batch_size"]
    reqs = [cs.make_request(rng, batch, cs.N_COMM, cs.COMM_SIZE)
            for _ in range(args.repeats)]
    for way, graphed in WAYS.items():
        pred._graphed = graphed
        for r in reqs:  # buckets met here for the first time
            pred(r)
        it = iter(reqs * 2)
        device_ms, top = profile(lambda: pred(next(it)), len(reqs))
        print(json.dumps({
            "traced_requests": len(reqs), "batch": batch, "way": way,
            "device_ms_per_request": device_ms,
            "untraced_idle_share": 1 - device_ms / median_ms[batch][way],
            "by_kernel_us_per_request": top}), flush=True)
    pred._graphed = True

    trainer = Trainer(model, graph, feats, TrainConfig(
        batch_size=batch, loss="bce"))
    for split in ("val", "test"):
        pos, y = cs.size_labelled_subgraphs(rng, cs.EVAL_SPLIT, cs.N_COMM,
                                            cs.COMM_SIZE)
        b, y_p, _ = make_eval_batches(pos, y, batch, rng)
        y_pad, mask = pad_eval_labels(y_p, b.shape[0], batch)
        out = {"eval_split": split, "subgraphs": len(pos),
               "batches": b.shape[0]}
        for way, graphed in WAYS.items():
            trainer._graphed = graphed
            score = trainer.evaluate_score(b, y_pad, mask)  # graphed: captures
            ms = [host_ms(lambda: trainer.evaluate_score(b, y_pad, mask))
                  for _ in range(args.repeats)]
            device_ms, _ = profile(
                lambda: trainer.evaluate_score(b, y_pad, mask), 5)
            out.update({f"{way}_median_ms": statistics.median(ms),
                        f"{way}_device_ms": device_ms,
                        f"{way}_idle_share": 1 - device_ms
                        / statistics.median(ms),
                        f"{way}_micro_f1": score})
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a GLASS serving request's time goes in the PyTorch/H100 port.

Builds the em_user-configuration model and stand-in graph of chip_smoke.py
on one CUDA card, then:
  1. times requests of 1, 6 and 64 subgraphs through Predictor on the host
     clock (each ends in a device-to-host copy of the logits, so the clock
     covers the device work), median and max over ``--repeats`` requests;
  2. traces ``--repeats`` requests of 6 subgraphs with torch.profiler and
     prints device time by kernel and device time per request. The wall
     time under the trace includes the profiler's own cost, so the card's
     idle share is taken against the untraced median of step 1.
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
from glass_tpu_torch import Predictor, build_graph  # noqa: E402
from glass_tpu_torch.ops import bcsr_spmm as bs  # noqa: E402


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
    model = cs.em_user_model(int(feats_np.max()), "pallas", device)
    pred = Predictor(model, graph, torch.from_numpy(feats_np).to(device),
                     device=device)
    rng = np.random.default_rng(args.seed)
    median_ms = {}
    for batch in cs.REQUEST_BATCHES:
        reqs = [cs.make_request(rng, batch, cs.N_COMM, cs.COMM_SIZE)
                for _ in range(args.repeats + 2)]
        for r in reqs[:2]:  # warm-up
            pred(r)
        ms = []
        for r in reqs[2:]:
            t0 = time.perf_counter()
            pred(r)
            ms.append((time.perf_counter() - t0) * 1e3)
        median_ms[batch] = statistics.median(ms)
        print(json.dumps({"request_batch": batch, "n": len(ms),
                          "median_ms": median_ms[batch],
                          "max_ms": max(ms)}), flush=True)

    batch = cs.EM_USER["batch_size"]
    reqs = [cs.make_request(rng, batch, cs.N_COMM, cs.COMM_SIZE)
            for _ in range(args.repeats)]
    launches = bs.bcsr_spmm.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            pred(r)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({
        "traced_requests": len(reqs), "batch": batch,
        "kernel_launches": bs.bcsr_spmm.launches - launches,
        "traced_wall_ms_per_request": wall_ms / len(reqs),
        "device_ms_per_request": device_ms / len(reqs),
        "untraced_idle_share": 1 - device_ms / len(reqs) / median_ms[batch],
        "by_kernel_us_per_request": [
            [e.key, e.self_device_time_total / len(reqs)] for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

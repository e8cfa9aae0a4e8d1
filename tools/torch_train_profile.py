#!/usr/bin/env python3
"""Where a GLASS training step's time goes in the PyTorch/H100 port.

Builds the em_user-configuration model (dropout 0.5, batch 6, lr 1e-3) and
the stand-in graph of chip_smoke.py on one CUDA card, banded-slab layout
at ``--dense_dtype`` (f32, bf16 or int8 slabs), the model at
``--compute_dtype`` (f32 or bf16 activations), and size-labelled synthetic
subgraphs, then:
  1. times ``--epochs`` untraced epochs of ``--steps`` steps through
     Trainer.train_epoch on the host clock (each epoch ends in a readback
     of its losses, so the clock covers the device work), after one
     warm-up epoch: ms per step, median and max over the epochs;
  2. traces one more epoch with torch.profiler and prints device time by
     kernel (user annotations, which span kernels counted already, left
     out) and device time per step. The wall time under the trace
     includes the profiler's own cost, so the card's idle share is taken
     against the untraced median of step 1.
``--fused_norm 1`` runs every GraphNorm through the fused kernels of
csrc/graph_norm.cu (GLASS_TPU_FUSED_NORM=1), 0 through the unfused formula.
Each step replays the Trainer's captured CUDA graph, as training on the
card does. Prints one JSON line per result. Run from the repository root:

    python3 tools/torch_train_profile.py [--steps 20] [--epochs 5] \
        [--dense_dtype f32|bf16|int8] [--compute_dtype f32|bf16] \
        [--fused_norm 0|1]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402  (the stand-in graph, model and data)
from glass_tpu_torch import TrainConfig, Trainer, build_graph  # noqa: E402
from glass_tpu_torch.ops import band_spmm as bd  # noqa: E402
from glass_tpu_torch.ops import fused_norm as fn  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20, help="steps per epoch")
    ap.add_argument("--epochs", type=int, default=5, help="untraced epochs")
    ap.add_argument("--seed", type=int, default=15, help="subgraph seed")
    ap.add_argument("--dense_dtype", choices=("f32", "bf16", "int8"),
                    default="f32", help="adjacency (band slab) dtype")
    ap.add_argument("--compute_dtype", choices=("f32", "bf16"), default="f32",
                    help="activation dtype (bf16: mixed precision)")
    ap.add_argument("--fused_norm", choices=("0", "1"), default="0",
                    help="GLASS_TPU_FUSED_NORM for the run")
    args = ap.parse_args()
    os.environ["GLASS_TPU_FUSED_NORM"] = args.fused_norm
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(json.dumps({"card": cs.card_line(), "dense_dtype": args.dense_dtype,
                      "compute_dtype": args.compute_dtype,
                      "fused_norm": args.fused_norm}), flush=True)

    ei, n = cs.clustered_graph()
    graph = build_graph(ei, None, n, cs.EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="band", dense_dtype=args.dense_dtype,
                        device=device)
    feats_np = cs.degree_features(ei, n)
    model = cs.em_user_model(
        int(feats_np.max()), "pallas", device, dropout=cs.EM_USER["dropout"],
        compute_dtype="bfloat16" if args.compute_dtype == "bf16" else None)
    bsz = cs.EM_USER["batch_size"]
    trainer = Trainer(model, graph, torch.from_numpy(feats_np).to(device),
                      TrainConfig(lr=cs.EM_USER["lr"], resi=cs.EM_USER["resi"],
                                  batch_size=bsz, loss="bce"))
    trainer.init(0)
    rng = np.random.default_rng(args.seed)
    pos, y = cs.size_labelled_subgraphs(rng, args.steps * bsz, cs.N_COMM,
                                        cs.COMM_SIZE)
    pos_b = pos.reshape(args.steps, bsz, -1)
    y_b = y.reshape(args.steps, bsz)

    # warm-up; the wrappers count a launch when they are called, and this
    # epoch calls them for its first (eager) step and its capture only
    launches = bd.band_spmm.launches
    norm_launches = fn.fused_graph_norm.launches
    trainer.train_epoch(pos_b, y_b)
    ms = []
    for _ in range(args.epochs):
        t0 = time.perf_counter()
        trainer.train_epoch(pos_b, y_b)
        ms.append((time.perf_counter() - t0) * 1e3 / args.steps)
    median = statistics.median(ms)
    print(json.dumps({"untraced_epochs": args.epochs, "steps": args.steps,
                      "batch": bsz, "median_ms_per_step": median,
                      "max_ms_per_step": max(ms)}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(pos_b, y_b)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # user annotations (Adam's "Optimizer.step#Adam.step") span kernels
    # already counted: leave them out of the sum
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]
    print(json.dumps({
        "traced_steps": args.steps,
        "band_launches_per_step":
            (bd.band_spmm.launches - launches) / 2,
        "norm_launches_per_step":
            (fn.fused_graph_norm.launches - norm_launches) / 2,
        "device_kernels_per_step":
            sum(e.count for e in kernels) / args.steps,
        "traced_wall_ms_per_step": wall_ms / args.steps,
        "device_ms_per_step": device_ms / args.steps,
        "untraced_idle_share": 1 - device_ms / args.steps / median,
        "by_kernel_us_per_step": [
            [e.key[:100], e.count / args.steps,
             e.self_device_time_total / args.steps]
            for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

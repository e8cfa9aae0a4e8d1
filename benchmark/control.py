#!/usr/bin/env python3
"""The readings that the check's limits are set from, for one cell over
many seeds in one process (the benchmark's own runs never run this):

- ``program``: the program against the reference, as a run compares it
  (the training cells' first steps; the serving cells' sample of a short
  window at the cell's load);
- ``control``: the reference in the nearest precision below the
  configuration's (f32 with TF32 off), that is with TF32 on, put in the
  program's place;
- ``half_batch`` (training cells): the reference with the loss taken over
  the first half of each batch only, a fault planted in the reference
  put in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2]

Prints one JSON line a seed, with the verdict of the cell's limits
(``benchmark/limits/<cell>.json``) on each side, and, last, each number's
largest program reading and smallest control and fault readings, and
the seeds on which the program failed or the control or a fault passed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.pycache_prefix = str(ROOT / "build" / "bench_cache" / "pycache")
sys.dont_write_bytecode = False


def readings(cell, seed: int, seconds: float, limits: dict) -> dict:
    from benchmark.compare import (judge, moving_leaves, serve_numbers,
                                   train_numbers)

    cell.setup(seed)
    if cell.mode == "serve":
        cell.window(seconds)
    cell.after_window()
    cell.free_program()
    out = dict(seed=seed, plan=cell.plan)
    if cell.mode == "train":
        ref = cell.reference_record()
        out["left_out"] = sorted(set(ref["grad_norms"])
                                 - set(moving_leaves(ref["grad_norms"])))
        out["program"] = train_numbers(cell.prog_record, ref)
        out["widest"] = widest(cell.prog_record, ref)
        out["control"] = train_numbers(cell.reference_record(tf32=True), ref)
        out["half_batch"] = train_numbers(
            cell.reference_record(half_batch=True), ref)
    else:
        ref = cell.reference_logits(cell.picked)
        out["program"] = serve_numbers(cell.prog_logits, ref)
        out["control"] = serve_numbers(
            cell.reference_logits(cell.picked, tf32=True), ref)
    out["passes"] = {side: judge(out[side], limits)[0]
                     for side in ("program", "control", "half_batch")
                     if side in out}
    return out


def widest(prog: dict, ref: dict) -> dict:
    """Where a training cell's widest gaps lie: the step of the loss's and
    the leaf of the change's."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    change = {k: abs(prog["change_norms"][k] - v)
              for k, v in ref["change_norms"].items()}
    leaf = max(change, key=change.get)
    return dict(loss_gaps=losses, change_leaf=leaf,
                change_leaf_norm=ref["change_norms"][leaf])


def summary(rows: list) -> dict:
    out = {}
    for k in rows[0]["program"]:
        out[k] = dict(program_max=max(r["program"][k] for r in rows))
        for side in ("control", "half_batch"):
            if side in rows[0]:
                out[k][f"{side}_min"] = min(r[side][k] for r in rows)
    # the seeds that go against the limits: a program run that fails, a
    # control or fault that passes
    out["against_limits"] = {
        side: [r["seed"] for r in rows
               if r["passes"][side] != (side == "program")]
        for side in rows[0]["passes"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="a serving cell's window a seed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import cells, harness

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(ROOT)
    w = harness.workload(spec, args.workload)
    cfg = harness.load_json(harness.config_file(spec, ROOT, w["config"]))
    bench = ROOT / "benchmark"
    traffic = harness.load_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = harness.load_json(bench / "limits" / f"{args.workload}.json")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = cells.make_cell(cfg, traffic, torch.device("cuda", 0))
        row = readings(cell, seed, args.seconds, limits)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del cell
    print(json.dumps(dict(workload=args.workload, summary=summary(rows))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Fit the layout planner's cost model on one CUDA card: the counterpart of
tools/autotune.py for the PyTorch/H100 port.

Wraps glass_tpu_torch/ops/autotune.py::fit_cost_constants (the experiment
CLI's ``--autotune`` runs the same fit and caches it under
~/.cache/glass_tpu_torch/), writes the three-key calibration file that
GLASS_TPU_AUTOTUNE points either package's planner at, with the port's
sparse-block costs beside them (ops/autotune.py::fit_sblock_constants: two
more keys, which no planner reads; they are recorded in ops/graph.py's
_SBLOCK_* constants), and prints it as one JSON line with the card's name
and power limit. The planner's other rates
(the dense matmul's, the segment SpMM's, the card's fill) are measured by
chip_smoke.py's [planner_rates] phase.

    python3 tools/torch_autotune.py --out autotune.json
    export GLASS_TPU_AUTOTUNE=$PWD/autotune.json

``--device cpu`` fits the plain versions' host times (testing only: they
describe no card).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from glass_tpu_torch.ops.autotune import (  # noqa: E402
    fit_cost_constants, fit_sblock_constants)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default="autotune.json")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_autotune: no CUDA card (pass --device cpu to exercise "
              "the fit on the plain versions)", file=sys.stderr)
        return 1
    card = card_line() if args.device == "cuda" else "cpu"
    out = fit_cost_constants(iters=args.iters, hidden=args.hidden,
                             device=args.device)
    out.update(fit_sblock_constants(iters=args.iters, hidden=args.hidden,
                                    device=args.device))
    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(dict(out, card=card)), flush=True)
    print(f"\nexport GLASS_TPU_AUTOTUNE={Path(args.out).resolve()}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

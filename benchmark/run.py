#!/usr/bin/env python3
"""Runs one cell of BENCHMARK.json once, on the CUDA cards of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (inputs from the seed, the program's graph build, model, the
check's first steps or the request pool, warm-up) runs first; then the
window measures for ``--seconds`` (``--trace 1``: the window, at most
the traffic's ``trace_seconds``, under the profiler). The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared with its limit,
which also end standard error. Exits non-zero, printing no result,
without as many CUDA cards as the cell asks for, or if JAX, flax or the
JAX package is loaded once the window has closed, or where the program it
would measure, ``glass_tpu_torch``, is not the checkout's own.

Every build and kernel cache, and the byte code of every module imported,
lies under ``build/`` of the checkout.
"""

import sys
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the byte code of every module a run imports, torch's too, compiled once a
# checkout and kept there (an installed package's own cache may be missing
# or unwritable, and PYTHONDONTWRITEBYTECODE set)
sys.pycache_prefix = str(ROOT / "build" / "bench_cache" / "pycache")
sys.dont_write_bytecode = False
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    program = importlib.util.find_spec("glass_tpu_torch")
    if program is None or not Path(program.origin).resolve().is_relative_to(
            ROOT):
        where = program.origin if program else "nowhere"
        print(f"run.py: glass_tpu_torch is not in this checkout ({ROOT}), "
              f"but {where}", file=sys.stderr)
        return 2

    import torch

    from benchmark import harness

    spec = harness.load_spec(ROOT)
    chips = harness.workload(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {chips} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0,
                              spec)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"run.py: loaded after the window: {loaded}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""HBM read-bandwidth probes on one CUDA card: the counterpart of
tools/hbm_probe.py for the PyTorch/H100 port.

Probes:

1. copy:   x.add_(1) over a large f32 array, repeated (PyTorch's own
           elementwise kernel; counts read + write bytes).
2. read:   the port's probe kernel (glass_tpu_torch/csrc/hbm_probe.cu)
           streams the array through shared memory in chunks of
           --chunk_rows rows, S stripe copies per chunk on separate
           mbarriers, double-buffered, `iters` passes in one launch. Read
           bytes only. S in {1, 2, 4, 8}.
3. read2:  the same with stripe s read from array s, S in {2, 4}.

Timing is differential, as the TPU tool's: (time(iters) - time(iters//4))
/ (iters - iters//4), each time the least of 3, by CUDA events, so the
launch's fixed cost cancels. Prints GB/s and the share of the card's
3.35 TB/s per probe, and one JSON line with all results. Run from the
repository root on a machine with a card:

    python3 tools/torch_hbm_probe.py [--mb 512] [--iters 40] \
        [--chunk_rows 2048] [--probes copy,read,read2]

It exits non-zero without a card or where the kernel fails to build or
launch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from glass_tpu_torch.ops import hbm_probe as hp  # noqa: E402

PEAK_HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
READ_STRIPES = (1, 2, 4, 8)
READ2_STRIPES = (2, 4)


def probe_rows(mb: int, chunk_rows: int) -> int:
    """Rows of 512 f32 in ``mb`` MiB, cut to a multiple of 8 chunks (the
    TPU tool's rule)."""
    rows = mb * 1024 * 1024 // hp.ROW_BYTES
    return rows - rows % (8 * chunk_rows)


def differential_seconds(timer: Callable[[int], float], iters: int) -> float:
    """Seconds per pass: (least of 3 timer(iters) - least of 3
    timer(iters // 4, at least 1)) / (iters - iters // 4)."""
    lo, hi = max(iters // 4, 1), iters
    if hi <= lo:
        raise ValueError(f"iters {iters} leaves no passes to difference")
    t_hi = min(timer(hi) for _ in range(3))
    t_lo = min(timer(lo) for _ in range(3))
    return (t_hi - t_lo) / (hi - lo)


def event_seconds(fn: Callable[[], object]) -> float:
    """Seconds of ``fn()`` on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def result(name: str, stripes, seconds: float, nbytes: int) -> dict:
    bps = nbytes / seconds
    return {"probe": name, "stripes": stripes, "us_per_pass": seconds * 1e6,
            "gb_per_s": bps / 1e9, "share_of_peak": bps / PEAK_HBM_BYTES_PER_S,
            "bytes_per_pass": nbytes}


def print_result(r: dict, note: str) -> None:
    s = "" if r["stripes"] is None else f" S={r['stripes']}"
    print(f"{r['probe'] + s:<11}: {r['us_per_pass']:9.1f} us/pass "
          f"{r['gb_per_s']:8.1f} GB/s  {100 * r['share_of_peak']:5.1f} % of "
          f"3.35 TB/s ({note})", flush=True)


def copy_probe(rows: int, iters: int) -> dict:
    x = torch.ones((rows, hp.LANES), dtype=torch.float32, device="cuda")

    def timer(n):
        def run():
            for _ in range(n):
                x.add_(1.0)
        return event_seconds(run)

    timer(1)
    r = result("copy", None, differential_seconds(timer, iters),
               2 * rows * hp.ROW_BYTES)
    print_result(r, "read + write")
    return r


def read_probe(rows: int, iters: int, stripes: int, chunk_rows: int) -> dict:
    x = torch.ones((rows, hp.LANES), dtype=torch.float32, device="cuda")

    def timer(n):
        return event_seconds(lambda: hp.hbm_read(x, chunk_rows, stripes, n))

    timer(1)  # builds the kernel
    r = result("read", stripes, differential_seconds(timer, iters),
               rows * hp.ROW_BYTES)
    print_result(r, f"read only, {rows // chunk_rows} chunks x "
                    f"{chunk_rows * hp.ROW_BYTES // 1024} KiB")
    return r


def read2_probe(rows: int, iters: int, stripes: int, chunk_rows: int) -> dict:
    per_rows = rows // chunk_rows * (chunk_rows // stripes)
    xs = [torch.ones((per_rows, hp.LANES), dtype=torch.float32, device="cuda")
          for _ in range(stripes)]

    def timer(n):
        return event_seconds(lambda: hp.hbm_read2(xs, chunk_rows, n))

    timer(1)
    r = result("read2", stripes, differential_seconds(timer, iters),
               rows * hp.ROW_BYTES)
    print_result(r, f"read only, {stripes} arrays")
    return r


def run(mb: int, iters: int, chunk_rows: int, probes) -> list:
    rows = probe_rows(mb, chunk_rows)
    hp.check_shape(rows, chunk_rows, 1, iters)
    print(f"array: {rows}x{hp.LANES} f32 = {rows * hp.ROW_BYTES / 2**20:.0f} "
          f"MiB, {torch.cuda.get_device_name(0)}", flush=True)
    out = []
    if "copy" in probes:
        out.append(copy_probe(rows, iters))
    if "read" in probes:
        out += [read_probe(rows, iters, s, chunk_rows) for s in READ_STRIPES]
    if "read2" in probes:
        out += [read2_probe(rows, iters, s, chunk_rows) for s in READ2_STRIPES]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=512)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--chunk_rows", type=int, default=2048)
    ap.add_argument("--probes", type=str, default="copy,read,read2")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_hbm_probe: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    results = run(args.mb, args.iters, args.chunk_rows,
                  args.probes.split(","))
    print(json.dumps({"card": card, "mb": args.mb, "iters": args.iters,
                      "chunk_rows": args.chunk_rows, "results": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Times the SpMM kernels of one checkout at the main path's shapes.

Imports ``chip_smoke`` and ``glass_tpu_torch`` from ``--root`` (a checkout
of any commit of the port, e.g. one unpacked with ``git archive`` into a
directory that .gitignore lists), builds the em_user stand-in graph of
chip_smoke.py in the banded-slab layout (rps 1) with f32, bf16 and int8
slabs and in the BCSR layout with f32, bf16 and int8 blocks, and the hpo
stand-in in the int8 dense layout, on one CUDA card, and prints one JSON
line: the card, the root, and each kernel's time at H = 64 (bf16 x for the
bf16 and int8 em_user layouts, f32 x otherwise, as chip_smoke.py times
them), three ways:

- ``<kernel>_ms``: chip_smoke.time_ms, CUDA events around back-to-back
  eager calls (median of groups): the wrapper's host work included where
  the card outruns it;
- ``<kernel>_device_ms``: the device time of one call, the median over
  DEVICE_REPS calls, each timed by CUDA events with the L2 cache flushed
  and the stream held by a spin kernel while the host enqueues it
  (chip_smoke.cold_ms's method): no host work, and no operand left in L2
  by the call before;
- ``<kernel>_host_us``: the host's time per call over HOST_CALLS eager
  calls without a synchronization, the median of HOST_GROUPS such runs
  (the card synchronized between them): the wrapper's enqueue cost when
  the card keeps up.

Two commits are compared by running it in turns within one call on one
card: parent, change, change, parent.

    python3 tools/torch_kernel_ab.py --root <checkout>
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

DEVICE_REPS = 20
HOST_CALLS, HOST_GROUPS = 200, 5
L2_FLUSH_BYTES = 128 << 20  # past the H100's 50 MB L2
HEAD_START_CYCLES = 4_000_000  # about 2 ms of the card's clock


def device_ms(torch, fn) -> float:
    """Device ms of one fn() with the L2 cache cold, the median over
    DEVICE_REPS calls: before each call a 128 MB fill and a spin kernel of
    about 2 ms, which holds the stream while the host enqueues the call
    between two CUDA events (chip_smoke.cold_ms's method, kept here so
    that every checkout is timed alike)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(DEVICE_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in spans)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose kernels are timed")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as cs
    from glass_tpu_torch import build_graph
    from glass_tpu_torch.ops import band_spmm as bd
    from glass_tpu_torch.ops import bcsr_spmm as bs
    from glass_tpu_torch.ops import dense_q as dq

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    ei, n = cs.clustered_graph()
    x = torch.randn(n, cs.EM_USER["hidden_dim"],
                    generator=torch.Generator().manual_seed(1)).to(device)
    result = {"card": cs.card_line(), "root": args.root,
              "package": str(Path(bd.__file__).resolve().parents[1])}
    xb = x.to(torch.bfloat16)

    def timed(key, fn):
        result[f"{key}_ms"] = cs.time_ms(fn)
        result[f"{key}_device_ms"] = device_ms(torch, fn)
        spans = []
        for _ in range(HOST_GROUPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            spans.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
        result[f"{key}_host_us"] = statistics.median(spans)

    for layout, dd in (("band", "f32"), ("band", "bf16"), ("band", "int8"),
                       ("bcsr", "f32"), ("bcsr", "bf16"), ("bcsr", "int8")):
        graph = build_graph(ei, None, n, cs.EM_USER["aggr"],
                            materialize_bcsr=True, sparse_layout=layout,
                            band_rps=1, dense_dtype=dd, device=device)
        v = x if dd == "f32" else xb
        if layout == "band":
            timed(f"band_{dd}", lambda: bd.band_spmm(graph.band, v))
        else:
            timed(f"bcsr_{dd}", lambda: bs.bcsr_spmm(graph.bcsr, v))
        del graph
    ei, n = cs.hpo_graph()
    graph = build_graph(ei, None, n, cs.HPO_METAB["aggr"],
                        materialize_dense=True, dense_dtype="int8",
                        device=device)
    x = torch.randn(n, cs.HPO_METAB["hidden_dim"],
                    generator=torch.Generator().manual_seed(1)).to(device)
    timed("dense_q", lambda: dq.dense_q_spmm(graph.dense_q, None, x))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

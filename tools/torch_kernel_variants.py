#!/usr/bin/env python3
"""Times the memory ring of the tensor-core SpMM kernels alone, beside the
whole kernel, at the main path's shapes, to show what holds each back.

Each of ``csrc/dense_q_spmm.cu``, ``csrc/band_spmm.cu`` and
``csrc/bcsr_spmm.cu`` is built a second time with ``-DGLASS_RING_ONLY`` (the
flags of ``glass_tpu_torch/ops/_build.py`` otherwise, into
``build/variants/``, all builds started together). That build keeps the
kernel's copies and drops its arithmetic: the dense kernel streams q alone
(no x tiles, no widening, no wgmma); the f32 band and BCSR kernels fill
their cp.async ring and multiply nothing; the bf16 and int8 band and BCSR
kernels stream their A tiles through the TMA ring alone (no x tiles, no
widening, no wgmma). Its output is wrong and not checked; its time is the
memory pipeline's. Both builds are loaded in turn in place of the
package's library and timed by chip_smoke.cold_ms (device time by CUDA
events, the L2 cache flushed before each call):

- ``dense_q_spmm`` on the hpo stand-in's int8 dense layout (14,587 nodes,
  H = 64, f32 x), beside ``torch.matmul`` of q's bf16 copy;
- ``band_spmm`` on the em_user stand-in's band (rps 1, H = 64) with f32,
  bf16 and int8 slabs, and ``bcsr_spmm`` on its BCSR layout with f32, bf16
  and int8 blocks (f32 x for f32 layouts, bf16 x otherwise).

Prints one JSON line with the card's name and power limit. On one card:

    python3 tools/torch_kernel_variants.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCES = ("dense_q_spmm", "band_spmm", "bcsr_spmm")


def build_ring_only(build_mod) -> dict:
    """source -> its library built with -DGLASS_RING_ONLY."""
    nvcc = build_mod.find_nvcc()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in SOURCES:
        lib = out / f"lib{src}-ring_only.so"
        procs[src] = (lib, subprocess.Popen(
            [nvcc, *build_mod.NVCC_FLAGS, "-DGLASS_RING_ONLY", "-o", str(lib),
             str(build_mod.CSRC / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{src} ring only: nvcc exit {proc.returncode}"
                               f"\n{log}")
        libs[src] = ctypes.CDLL(str(lib))
    return libs


def time_both(build_mod, src: str, ring_only, fn) -> dict:
    """fn's device time (chip_smoke.cold_ms) with the package's library
    and with the ring-only one."""
    import chip_smoke as cs

    build_mod._LOADED.pop(src, None)
    result = {"kernel_ms": cs.cold_ms(fn)}
    build_mod._LOADED[src] = ring_only
    try:
        result["ring_only_ms"] = cs.cold_ms(fn)
    finally:
        build_mod._LOADED.pop(src)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from glass_tpu_torch import build_graph
    from glass_tpu_torch.ops import _build
    from glass_tpu_torch.ops import band_spmm as bd
    from glass_tpu_torch.ops import bcsr_spmm as bs
    from glass_tpu_torch.ops import dense_q as dq

    device = torch.device("cuda")
    libs = build_ring_only(_build)
    result = {"card": cs.card_line()}

    ei, n = cs.hpo_graph()
    layout = build_graph(ei, None, n, cs.HPO_METAB["aggr"],
                         materialize_dense=True, dense_dtype="int8",
                         device=device).dense_q
    x = torch.randn(n, cs.HPO_METAB["hidden_dim"],
                    generator=torch.Generator().manual_seed(1)).to(device)
    q_bf16 = layout.q.to(torch.bfloat16)
    x_pad = torch.zeros(layout.q.shape[1], x.shape[1], dtype=torch.bfloat16,
                        device=device)
    x_pad[:n] = x
    result["dense_q_spmm"] = time_both(
        _build, "dense_q_spmm", libs["dense_q_spmm"],
        lambda: dq.dense_q_spmm(layout, None, x))
    result["dense_q_spmm"]["library_ms"] = cs.cold_ms(
        lambda: torch.matmul(q_bf16, x_pad))
    del layout, q_bf16, x_pad

    ei, n = cs.clustered_graph()
    x = torch.randn(n, cs.EM_USER["hidden_dim"],
                    generator=torch.Generator().manual_seed(1)).to(device)
    for layout, dd in (("band", "f32"), ("band", "bf16"), ("band", "int8"),
                       ("bcsr", "f32"), ("bcsr", "bf16"), ("bcsr", "int8")):
        graph = build_graph(ei, None, n, cs.EM_USER["aggr"],
                            materialize_bcsr=True, sparse_layout=layout,
                            band_rps=1, dense_dtype=dd, device=device)
        v = x if dd == "f32" else x.to(torch.bfloat16)
        if layout == "band":
            fn = lambda g=graph, v=v: bd.band_spmm(g.band, v)  # noqa: E731
        else:
            fn = lambda g=graph, v=v: bs.bcsr_spmm(g.bcsr, v)  # noqa: E731
        src = f"{layout}_spmm"
        result[f"{src}_{dd}"] = time_both(_build, src, libs[src], fn)
        del graph
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

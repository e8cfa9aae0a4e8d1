#!/usr/bin/env python3
"""Times the SpMM kernels of one checkout at the main path's shapes.

Imports ``chip_smoke`` and ``glass_tpu_torch`` from ``--root`` (a checkout
of any commit of the port, e.g. one unpacked with ``git archive`` into a
directory that .gitignore lists), builds the em_user stand-in graph of
chip_smoke.py in the banded-slab layout (rps 1) with f32, bf16 and int8
slabs and in the BCSR layout with f32 and int8 blocks, and the hpo stand-in
in the int8 dense layout, on one CUDA card, and prints one JSON line: the
card, the root, and each kernel's time at H = 64 (median of CUDA event
groups, chip_smoke.time_ms; bf16 x for the bf16 and int8 em_user layouts,
f32 x otherwise, as chip_smoke.py times them). Two commits are compared by
running it in turns within one call on one card: parent, change, change,
parent.

    python3 tools/torch_kernel_ab.py --root <checkout>
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


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
    for layout, dd in (("band", "f32"), ("band", "bf16"), ("band", "int8"),
                       ("bcsr", "f32"), ("bcsr", "int8")):
        graph = build_graph(ei, None, n, cs.EM_USER["aggr"],
                            materialize_bcsr=True, sparse_layout=layout,
                            band_rps=1, dense_dtype=dd, device=device)
        v = x if dd == "f32" else xb
        if layout == "band":
            result[f"band_{dd}_ms"] = cs.time_ms(
                lambda: bd.band_spmm(graph.band, v))
        else:
            result[f"bcsr_{dd}_ms"] = cs.time_ms(
                lambda: bs.bcsr_spmm(graph.bcsr, v))
        del graph
    ei, n = cs.hpo_graph()
    graph = build_graph(ei, None, n, cs.HPO_METAB["aggr"],
                        materialize_dense=True, dense_dtype="int8",
                        device=device)
    x = torch.randn(n, cs.HPO_METAB["hidden_dim"],
                    generator=torch.Generator().manual_seed(1)).to(device)
    result["dense_q_ms"] = cs.time_ms(
        lambda: dq.dense_q_spmm(graph.dense_q, None, x))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

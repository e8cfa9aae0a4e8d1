#!/usr/bin/env python3
"""Times the f32 band and BCSR kernels of one checkout at the em_user shape.

Imports ``chip_smoke`` and ``glass_tpu_torch`` from ``--root`` (a checkout
of any commit of the port, e.g. one unpacked with ``git archive`` into a
directory that .gitignore lists), builds the stand-in graph of chip_smoke.py
in the banded-slab and the BCSR layout on one CUDA card, and prints one JSON
line: the card, the root, and each kernel's time at H = 64 (median of CUDA
event groups, chip_smoke.time_ms). Two commits are compared by running it in
turns within one call on one card: parent, change, change, parent.

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

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    ei, n = cs.clustered_graph()
    x = torch.randn(n, cs.EM_USER["hidden_dim"],
                    generator=torch.Generator().manual_seed(1)).to(device)
    result = {"card": cs.card_line(), "root": args.root,
              "package": str(Path(bd.__file__).resolve().parents[1])}
    for layout in ("band", "bcsr"):
        graph = build_graph(ei, None, n, cs.EM_USER["aggr"],
                            materialize_bcsr=True, sparse_layout=layout,
                            device=device)
        if layout == "band":
            result["band_f32_ms"] = cs.time_ms(lambda: bd.band_spmm(graph.band, x))
        else:
            result["bcsr_f32_ms"] = cs.time_ms(lambda: bs.bcsr_spmm(graph.bcsr, x))
        del graph
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""SSL pretraining CLI of the port, flag-compatible with
``glass_tpu/cli/gnn_emb.py`` (reference: GNNEmb.py:12-33 argparse surface).

Usage, on the card:
    python -m glass_tpu_torch.cli.gnn_emb --dataset em_user --use_nodeid \\
        --data_root <dir> [--spmm pallas] [--optruns N] [--path Emb/]
and on the CPU with ``--device -1``. Writes the best (N, 64) node table of
the search to ``{path}/{name}_64.npz`` under key 'embedding' (the table
``glass_test --use_nodeid --emb_path {path}`` loads) and the resumable
study to ``{path}/{name}.db``; ``--optruns`` is the study's total budget,
so a run that finds the budget spent trains nothing.

Differences from the JAX CLI:
- ``--device`` -1 runs on the CPU (the kernels' plain versions); any other
  value runs on the CUDA card and raises without one.
- ``--autotune`` fits the layout planner's cost constants on the device
  ``--device`` names (``ops.autotune.ensure_autotune``); the default file
  is ``~/.cache/glass_tpu_torch/autotune_cuda-<key>.json``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from glass_tpu_torch.utils.checkpoint import atomic_savez

HIDDEN = 64  # gnn_emb writes 64-d tables (GNNEmb.py hidden=64)


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SSL node-embedding pretraining")
    parser.add_argument("--dataset", type=str, default="ppi_bp")
    parser.add_argument("--use_deg", action="store_true")
    parser.add_argument("--use_one", action="store_true")
    parser.add_argument("--use_nodeid", action="store_true")
    parser.add_argument("--repeat", type=int, default=1)
    # reference-compat no-op flags (GNNEmb.py:24-25)
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--abl", action="store_true")
    parser.add_argument("--optruns", type=int, default=100)
    parser.add_argument("--path", type=str, default="Emb/")
    parser.add_argument("--name", type=str, default=None,
                        help="output / study name (default: dataset)")
    parser.add_argument("--device", type=int, default=0,
                        help="-1 runs on the CPU; otherwise the CUDA card")
    parser.add_argument("--use_seed", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_epochs", type=int, default=100)
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--sampler", type=str, default="tpe",
                        choices=["tpe", "random"],
                        help="HPO sampler of the sqlite study (train/tpe.py TPE or "
                             "seeded random search)")
    parser.add_argument("--spmm", type=str, default=None,
                        choices=["dense", "segment", "pallas"])
    parser.add_argument("--autotune", action="store_true",
                        help="fit the layout planner's cost model on the "
                             "device (or reuse --autotune_file)")
    parser.add_argument("--autotune_file", type=str, default=None,
                        help="calibration JSON path for --autotune")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    device = "cpu" if args.device == -1 else "cuda"
    if args.autotune:
        from glass_tpu_torch.ops.autotune import ensure_autotune

        ensure_autotune(args.autotune_file, device=device)

    from glass_tpu_torch.train.ssl import SSLConfig, run_hpo

    if args.use_one:
        feature = "one"
    elif args.use_deg:
        feature = "deg"
    else:
        feature = "nodeid"  # reference recipe: --use_nodeid (README:55-57)

    name = args.name or args.dataset
    out_dir = Path(args.path)
    out_dir.mkdir(parents=True, exist_ok=True)
    table = out_dir / f"{name}_{HIDDEN}.npz"
    cfg = SSLConfig(
        dataset=args.dataset,
        feature=feature,
        hidden_dim=HIDDEN,
        repeat=args.repeat,
        max_epochs=args.max_epochs,
        spmm_mode=args.spmm,
        data_root=args.data_root,
        device=device,
    )

    def save_fn(emb: np.ndarray):
        atomic_savez(table, embedding=emb)
        print(f"saved {table}", flush=True)

    print(args)
    storage = f"sqlite:///{out_dir / (name + '.db')}"
    return run_hpo(cfg, n_trials=args.optruns, save_fn=save_fn,
                   storage=storage, sampler=args.sampler,
                   log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()

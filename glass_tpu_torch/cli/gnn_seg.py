"""GNN-seg baseline CLI, flag-compatible with the reference driver
(counterpart of ``glass_tpu/cli/gnn_seg.py``; reference GNNSeg.py:174-182,
391-395).

    python -m glass_tpu_torch.cli.gnn_seg --dataset density --repeat 10

runs on the CUDA card; ``--device -1`` runs on the CPU. The model takes
``BEST_HYPERPARAMS[--dataset]``. ``--test`` is parsed and unused, as in
the JAX CLI.
"""

from __future__ import annotations

import argparse


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="GNN-seg baseline")
    parser.add_argument("--dataset", type=str, default="ppi_bp")
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--device", type=int, default=0)
    parser.add_argument("--max_epochs", type=int, default=500)
    parser.add_argument("--data_root", type=str, default=None)
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from glass_tpu_torch.train.seg_protocol import (
        BEST_HYPERPARAMS,
        SegConfig,
        run_seg_experiment,
    )

    print(args)
    bhp = BEST_HYPERPARAMS[args.dataset]
    cfg = SegConfig(
        dataset=args.dataset,
        conv_layer=bhp["conv_layer"],
        dropout=bhp["dropout"],
        hidden_dim=bhp["hidden_dim"],
        repeat=args.repeat,
        max_epochs=args.max_epochs,
        data_root=args.data_root,
        device="cpu" if args.device == -1 else "cuda",
    )
    _, mean, err = run_seg_experiment(cfg)
    print(mean)
    print("best params", bhp, flush=True)
    return mean, err


if __name__ == "__main__":
    main()

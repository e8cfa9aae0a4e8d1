"""Batch inference CLI of the port: scores subgraphs with a GLASS checkpoint
(counterpart of ``glass_tpu/cli/glass_predict.py``, with its flags).

It rebuilds the model from the dataset's config exactly as the experiment
protocol does (``make_glass_model``), takes the protocol's route (above
8,192 nodes on the card: RCM order through the native library, the
"pallas" route and the layout planner's layout), loads a best-val
checkpoint that ``glass_test --ckpt_dir`` wrote (either package's ``.npz``)
and prints one TSV row per subgraph: its index, its original node ids, the
prediction and, with ``--logits``, the logits. Micro-F1 of a split goes to
stderr.

Usage:
    python -m glass_tpu_torch.cli.glass_test --dataset density --use_one \\
        --use_maxzeroone --repeat 1 --ckpt_dir ckpts          # train + save
    python -m glass_tpu_torch.cli.glass_predict --dataset density \\
        --use_one --use_maxzeroone --ckpt ckpts/density_seed0_best.npz

Subgraphs come from a dataset split (``--split test``, the default) or a
TSV (``--subgraphs``) whose first column is a '-'-joined node-id list (the
node column of SubGNN's ``subgraphs.pth``). They are scored in input order
(unshuffled eval batches), so the output is reproducible; the zero-one
labels depend on a batch's members, so one subgraph scored in another
batch can get other logits (the method's eval protocol).

Differences from the JAX CLI: ``--device -1`` runs on the CPU (the
kernels' plain versions), any other value on the CUDA card; the configs
are read without PyYAML (``glass_test.load_config``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="GLASS batch inference")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True,
                        help="params checkpoint (.npz written by "
                             "glass_test --ckpt_dir: {dataset}_seed{k}_best.npz)")
    parser.add_argument("--use_deg", action="store_true")
    parser.add_argument("--use_one", action="store_true")
    parser.add_argument("--use_nodeid", action="store_true")
    parser.add_argument("--use_maxzeroone", action="store_true")
    parser.add_argument("--split", type=str, default="test",
                        choices=["train", "valid", "test"],
                        help="dataset split to score (ignored with --subgraphs)")
    parser.add_argument("--subgraphs", type=str, default=None,
                        help="TSV of '-'-joined node ids, one subgraph per "
                             "line (extra tab-separated columns ignored)")
    parser.add_argument("--output", type=str, default="-",
                        help="output TSV path ('-' = stdout)")
    parser.add_argument("--logits", action="store_true",
                        help="append raw logits to each output row")
    parser.add_argument("--batch_size", type=int, default=0,
                        help="0 = the dataset config's batch_size")
    parser.add_argument("--device", type=int, default=0,
                        help="-1 runs on the CPU; otherwise the CUDA card")
    parser.add_argument("--spmm", type=str, default=None,
                        choices=["dense", "segment", "pallas"])
    parser.add_argument("--seed", type=int, default=0,
                        help="split-regeneration seed; must match the "
                             "training repeat's seed ((1<<r)-1) for the "
                             "synthetics' re-rolled splits to line up")
    parser.add_argument("--config_dir", type=str, default=None)
    parser.add_argument("--data_root", type=str, default=None)
    return parser


def read_subgraphs_file(path: str, n_node: int, pad: int) -> np.ndarray:
    """(S, pad) int64 pos matrix (pad = -1) from a TSV whose first column
    is a '-'-joined node-id list."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            nodes = [int(t) for t in line.split("\t")[0].split("-")]
            bad = [v for v in nodes if not 0 <= v < n_node]
            if bad:
                raise ValueError(f"node id {bad[0]} outside [0, {n_node})")
            rows.append(nodes)
    if not rows:
        raise ValueError(f"no subgraphs in {path}")
    width = max(pad, max(len(r) for r in rows))
    pos = np.full((len(rows), width), -1, dtype=np.int64)
    for i, r in enumerate(rows):
        pos[i, : len(r)] = r
    return pos


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    import torch

    from glass_tpu_torch.cli.glass_test import load_config
    from glass_tpu_torch.data.basegraph import relabel_pos
    from glass_tpu_torch.data.loaders import load_dataset
    from glass_tpu_torch.ops._common import resolve_device
    from glass_tpu_torch.ops.graph import build_graph
    from glass_tpu_torch.train.loop import (TrainConfig, Trainer,
                                            make_eval_batches)
    from glass_tpu_torch.train.metrics import binary_f1, micro_f1
    from glass_tpu_torch.train.protocol import (ExperimentConfig, _auto_route,
                                                apply_feature,
                                                make_glass_model)
    from glass_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  params_from_flax)

    if args.use_deg:
        feature = "deg"
    elif args.use_one:
        feature = "one"
    elif args.use_nodeid:
        feature = "nodeid"
    else:
        raise NotImplementedError("pick one of --use_deg / --use_one / --use_nodeid")

    device = resolve_device("cpu" if args.device == -1 else "cuda")
    cfg = ExperimentConfig(
        dataset=args.dataset, feature=feature,
        use_maxzeroone=args.use_maxzeroone, repeat=1, spmm_mode=args.spmm,
        data_root=args.data_root, device=device.type,
        **load_config(args.dataset, args.config_dir),
    )

    rng = np.random.default_rng(args.seed)
    base = load_dataset(cfg.dataset, rng, cfg.data_root)
    apply_feature(base, feature)
    spmm_mode, use_rcm = _auto_route(cfg, base.n_node, device)
    perm = None  # RCM relabeling: perm[new_id] = original id
    if use_rcm:
        from glass_tpu_torch.native import rcm_ordering

        # predictions do not depend on the order; the id <-> row map does
        perm = rcm_ordering(base.edge_index, base.n_node)
        base.relabel_nodes(perm)

    graph = build_graph(
        base.edge_index, base.edge_weight, base.n_node, cfg.aggr,
        materialize_dense=(None if spmm_mode is None
                           else spmm_mode == "dense"),
        dense_dtype=cfg.dense_dtype, materialize_bcsr=spmm_mode == "pallas",
        sparse_layout=cfg.sparse_layout, device=device,
    )
    model = make_glass_model(cfg, base, spmm_mode, device=device)
    params_from_flax(model, load_checkpoint(args.ckpt))
    tcfg = TrainConfig(lr=cfg.lr, resi=cfg.resi, batch_size=cfg.batch_size,
                       loss="bce" if base.binary else "ce",
                       use_z=cfg.use_maxzeroone)
    trainer = Trainer(model, graph,
                      torch.from_numpy(base.x.astype(np.int64)).to(device),
                      tcfg)

    y = None
    if args.subgraphs is not None:
        pos = read_subgraphs_file(args.subgraphs, base.n_node,
                                  base.pos.shape[1])
        if perm is not None:  # the file holds original ids
            pos = relabel_pos(pos, perm, base.n_node)
    else:
        pos, y = base.get_split(args.split)  # relabeled with the graph
        y = y.astype(np.float32 if base.binary else np.int64)
    batch_size = args.batch_size or cfg.batch_size

    # unshuffled batches: reproducible output
    dummy_y = np.zeros(pos.shape[0], np.float32) if y is None else y
    pos_b, y_p, n_real = make_eval_batches(pos, dummy_y, batch_size, rng=None)
    logits = trainer.evaluate(pos_b, n_real)

    if base.binary:
        pred = (logits > 0).astype(np.int64)
        pred_str = [",".join(map(str, row)) for row in pred]
    else:
        pred_str = [str(v) for v in logits.argmax(axis=-1)]

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for i in range(n_real):
            ids = pos[i][pos[i] >= 0]
            if perm is not None:  # report original node ids
                ids = np.asarray(perm)[ids]
            row = [str(i), "-".join(str(v) for v in ids), pred_str[i]]
            if args.logits:
                row.append(",".join(f"{v:.6g}"
                                    for v in np.atleast_1d(logits[i])))
            print("\t".join(row), file=out)
    finally:
        if out is not sys.stdout:
            out.close()

    if y is not None:
        score_fn = binary_f1 if base.binary else micro_f1
        score = score_fn(logits, y_p[:n_real])
        print(f"{args.split} micro-F1 {score:.4f} over {n_real} subgraphs",
              file=sys.stderr)
        return score
    return None


if __name__ == "__main__":
    main()

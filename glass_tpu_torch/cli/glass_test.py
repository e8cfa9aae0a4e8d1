"""GLASS experiment CLI of the port, flag-compatible with
``glass_tpu/cli/glass_test.py`` (reference: GLASSTest.py:14-30 argparse
surface, 272-279 main flow).

Usage, on the card:
    GLASS_TPU_FUSED_NORM=1 python -m glass_tpu_torch.cli.glass_test \\
        --dataset em_user --use_deg --use_maxzeroone --spmm pallas \\
        --sparse_layout band --data_root <dir>
and on the CPU with ``--device -1``.

Differences from the JAX CLI:
- ``--device`` -1 runs on the CPU (the kernels' plain versions); any other
  value runs on the CUDA card and raises without one.
- ``--autotune`` (ROADMAP Queue 1 item 6) and the multi-host flags
  ``--multihost``, ``--coordinator``, ``--num_processes``, ``--process_id``
  (item 12) raise ``NotImplementedError``; so do ``--graph_shards``,
  ``--data_shards`` > 1, ``--ring`` and ``--sharding`` (item 12).
- The configs are read by :func:`read_flat_config`, not PyYAML.
- ``--use_seed`` is a no-op, as in the JAX CLI: runs are always seeded per
  repeat (seed = (1 << repeat) - 1).
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="GLASS on one CUDA card")
    parser.add_argument("--dataset", type=str, default="ppi_bp")
    parser.add_argument("--use_deg", action="store_true")
    parser.add_argument("--use_one", action="store_true")
    parser.add_argument("--use_nodeid", action="store_true")
    parser.add_argument("--use_maxzeroone", action="store_true")
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--device", type=int, default=0,
                        help="-1 runs on the CPU; otherwise the CUDA card")
    parser.add_argument("--use_seed", action="store_true",
                        help="no-op (runs are always seeded; see module docstring)")
    parser.add_argument("--spmm", type=str, default=None,
                        choices=["dense", "segment", "pallas"],
                        help="SpMM strategy override (default: auto)")
    parser.add_argument("--dense_dtype", type=str, default="f32",
                        choices=["f32", "bf16", "int8"],
                        help="adjacency dtype (bf16 = fast non-parity mode; "
                        "int8 = quantized layouts with per-row dequant "
                        "scales)")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=["f32", "bf16"],
                        help="bf16 = mixed-precision training (bf16 "
                             "activations, f32 params/optimizer/loss)")
    parser.add_argument("--config_dir", type=str, default=None)
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--emb_path", type=str, default="Emb",
                        help="directory with pretrained {dataset}_{hidden}.npz tables")
    parser.add_argument("--max_epochs", type=int, default=300)
    parser.add_argument("--ckpt_dir", type=str, default=None,
                        help="save best-val params + full run state per repeat")
    parser.add_argument("--resume", action="store_true",
                        help="resume each repeat from ckpt_dir's run-state "
                             "checkpoint (bit-exact continuation)")
    parser.add_argument("--ckpt_every", type=int, default=10,
                        help="run-state checkpoint cadence in epochs")
    parser.add_argument("--rcm", action="store_true",
                        help="RCM-reorder nodes (locality for --spmm pallas)")
    parser.add_argument("--sparse_layout", type=str, default="auto",
                        choices=["auto", "bcsr", "band", "hybrid"],
                        help="block-sparse layout for --spmm pallas (auto "
                             "and hybrid: ROADMAP Queue 1 item 6)")
    parser.add_argument("--graph_shards", type=int, default=1,
                        help="node-partition the graph (ROADMAP Queue 1 item 12)")
    parser.add_argument("--data_shards", type=int, default=1,
                        help="data-parallel replicas (ROADMAP Queue 1 item 12)")
    parser.add_argument("--ring", action="store_true",
                        help="ring halo exchange (ROADMAP Queue 1 item 12)")
    parser.add_argument("--sharding", type=str, default=None,
                        choices=["auto"],
                        help="GSPMD-style sharding (ROADMAP Queue 1 item 12)")
    parser.add_argument("--report_auroc", action="store_true",
                        help="also log test AUROC at each test probe "
                             "(reference metrics.py implements auroc but "
                             "never calls it)")
    parser.add_argument("--autotune", action="store_true",
                        help="calibrate the layout planner's cost model "
                             "(ROADMAP Queue 1 item 6)")
    parser.add_argument("--autotune_file", type=str, default=None,
                        help="calibration JSON path for --autotune")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-host (ROADMAP Queue 1 item 12)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="multi-host: total process count")
    parser.add_argument("--process_id", type=int, default=None,
                        help="multi-host: this process's rank")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host bootstrap (ROADMAP Queue 1 item 12)")
    parser.add_argument("--cpu_collectives", type=str, default=None,
                        choices=["gloo", "mpi"],
                        help="multi-host off the card: collectives backend")
    parser.add_argument("--local_devices", type=int, default=None,
                        help="multi-host off the card: devices per process")
    return parser


# PyYAML's (YAML 1.1) resolvers for the plain scalars a flat config holds
_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?")


def _scalar(text: str):
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def read_flat_config(text: str) -> dict:
    """The ``key: scalar`` mapping of a flat YAML config, as
    ``yaml.safe_load`` reads one: null, booleans, decimal ints, floats with
    a point, quoted and plain strings; ``#`` comments and blank lines
    skipped. Anything else (nesting, lists, block scalars) raises
    ``ValueError``. The port needs no PyYAML."""
    out = {}
    for raw in text.splitlines():
        line = raw.split(" #", 1)[0].rstrip()
        if not line or line.lstrip().startswith("#"):
            continue
        key, sep, value = line.partition(": ")
        if not sep and line.endswith(":"):
            key, sep, value = line[:-1], ":", ""
        value = value.strip()
        if (not sep or key != key.strip() or not key or key in out
                or value[:1] in ("[", "{", "|", ">", "&", "*", "!")
                or value == "-" or value.startswith("- ")):
            raise ValueError(f"not a flat 'key: scalar' config line: {raw!r}")
        out[key] = _scalar(value)
    return out


def load_config(dataset: str, config_dir: str | None) -> dict:
    cdir = Path(config_dir) if config_dir else Path(__file__).parent.parent / "configs"
    return read_flat_config((cdir / f"{dataset}.yml").read_text())


def load_pretrained_table(emb_path: str, dataset: str, hidden_dim: int):
    """Loads a pretrained node-embedding table saved by the gnn_emb CLI
    (``.npz`` with key 'embedding'; contract of reference GNNEmb.py:186-188)."""
    p = Path(emb_path) / f"{dataset}_{hidden_dim}.npz"
    if not p.exists():
        # The table file is keyed by the config's hidden_dim, and gnn_emb
        # always writes 64-d tables (GNNEmb.py hidden=64), so --use_nodeid
        # needs a config with hidden_dim=64 (GLASSTest.py:153-157).
        have = sorted(q.name for q in Path(emb_path).glob(f"{dataset}_*.npz"))
        hint = (
            f" Found {have} in {emb_path}: the table's dim must equal the "
            f"config's hidden_dim ({hidden_dim}); gnn_emb writes 64-d tables, "
            f"so use a config with hidden_dim=64 (--config_dir)."
            if have
            else f" Run `python -m glass_tpu.cli.gnn_emb --dataset {dataset}` first."
        )
        raise FileNotFoundError(f"pretrained embedding {p} not found.{hint}")
    return np.load(p)["embedding"]


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    if args.autotune:
        raise NotImplementedError(
            "--autotune (the layout planner's calibration) is ROADMAP Queue 1 "
            "item 6, not ported yet")
    if (args.multihost or args.coordinator is not None
            or args.num_processes is not None or args.process_id is not None):
        raise NotImplementedError(
            "the multi-host flags are ROADMAP Queue 1 item 12, not ported yet")

    from glass_tpu_torch.train.protocol import ExperimentConfig, run_experiment

    log = print
    params = load_config(args.dataset, args.config_dir)
    log(args)
    log(f"params {params}")

    if args.use_deg:
        feature = "deg"
    elif args.use_one:
        feature = "one"
    elif args.use_nodeid:
        feature = "nodeid"
    else:
        raise NotImplementedError("pick one of --use_deg / --use_one / --use_nodeid")

    node_emb = None
    if args.use_nodeid:
        node_emb = load_pretrained_table(
            args.emb_path, args.dataset, params.get("hidden_dim", 64)
        )

    cfg = ExperimentConfig(
        dataset=args.dataset,
        feature=feature,
        use_maxzeroone=args.use_maxzeroone,
        repeat=args.repeat,
        max_epochs=args.max_epochs,
        spmm_mode=args.spmm,
        dense_dtype=args.dense_dtype,
        compute_dtype=(None if args.compute_dtype == "f32" else args.compute_dtype),
        node_emb=node_emb,
        data_root=args.data_root,
        ckpt_dir=args.ckpt_dir,
        resume=args.resume,
        ckpt_every=args.ckpt_every,
        rcm=args.rcm,
        sparse_layout=args.sparse_layout,
        graph_shards=args.graph_shards,
        data_shards=args.data_shards,
        ring=args.ring,
        sharding=args.sharding,
        report_auroc=args.report_auroc,
        device="cpu" if args.device == -1 else "cuda",
        **params,
    )
    _, mean, err = run_experiment(cfg, log=log)
    return mean, err


if __name__ == "__main__":
    main()

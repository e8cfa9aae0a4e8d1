"""A tiny copy of the benchmark (the real traffic and metric files, the
configurations cut to a few hundred nodes) in a temporary root, so that
the harness runs whole on the CPU in a test."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
FOUND_BY_NAME = ("traffic", "drivers", "graphs", "subgraphs", "metrics",
                 "limits", "reference")


def tiny_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    if cfg["graph"]["kind"] == "clustered":
        cfg["graph"].update(nodes=190, community_size=32,
                            undirected_edges=2000)
        cfg["subgraphs"].update(count=60, min_nodes=3, max_nodes=40)
    else:
        cfg["graph"].update(nodes=300, undirected_edges=3000)
        cfg["subgraphs"].update(count=200)
        cfg["model"]["batch_size"] = 16
    return cfg


def make_root(tmp: Path) -> Path:
    """tmp/BENCHMARK.json and tmp/benchmark/{configs,traffic,drivers,
    graphs,subgraphs,limits,metrics,reference}: the real files,
    configurations and serving pool cut down."""
    bench = tmp / "benchmark"
    for d in FOUND_BY_NAME:
        shutil.copytree(BENCH / d, bench / d)
    (bench / "configs").mkdir()
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        (tmp / c["file"]).write_text(json.dumps(tiny_config(cfg)))
    for path in (bench / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        if traffic["driver"] == "serve":
            traffic.update(pool=64, check_requests=16)
            path.write_text(json.dumps(traffic))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def run(root: Path, cell: str, traced: bool = False, seed: int = 2**31 + 5,
        seconds: float = 0.3) -> dict:
    from benchmark import harness

    return harness.run_cell(root, cell, seed, seconds, traced,
                            torch.device("cpu"), time.perf_counter())

"""One run of one cell: the spec read from ``BENCHMARK.json``, the cell's
files found by name, set-up, the window, the metrics, the check, and the
result line.

Found by name, so that a later cell or metric is a file added and never an
edit:

- the configuration's file (``benchmark/configs/<config>.json``, the path
  ``BENCHMARK.json`` gives);
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, whose
  ``driver`` names ``benchmark/drivers/<driver>.py`` (see ``cells.py``);
- the configuration's graph and subgraph recipes,
  ``benchmark/graphs/<kind>.py`` and ``benchmark/subgraphs/<kind>.py``,
  and the plain reference its ``reference`` names,
  ``benchmark/reference/<name>.py`` (see ``cells.reference``);
- ``benchmark/limits/<workload>.json``: the limit of each number the
  check compares;
- ``benchmark/metrics/<metric>.py``: a ``read(run)`` that returns the
  metric's value, or None where it finds nothing to read.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark import byname, cells
from benchmark import trace as tr
from benchmark.compare import judge
from benchmark.yardstick import ITEMSIZE, distinct_nnz

FORBIDDEN = ("jax", "jaxlib", "flax", "glass_tpu")


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                   f"{[w['name'] for w in spec['workloads']]}")


def config_file(spec: dict, root: Path, name: str) -> Path:
    for c in spec["configs"]:
        if c["name"] == name:
            return root / c["file"]
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric listed for ``cell``, or, without a list, for every cell
    that reports the end-to-end metric it moves (``reported``; an
    end-to-end metric without a list applies everywhere)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_reader(name: str, metrics_dir: Path):
    return byname.load(metrics_dir, name).read


class Run:
    """What a metric's reader reads: the cell (its inputs, spans, plan),
    the window's counts, the trace's reduction (None untraced) and the
    set-up time."""

    def __init__(self, cell: cells.Cell, stats: dict, setup_s: float,
                 trace: Optional[dict]):
        self.cell, self.stats, self.setup_s, self.trace = (cell, stats,
                                                           setup_s, trace)
        self.mode = cell.mode
        self.model = cell.model_cfg
        self._nnz: Optional[int] = None

    @property
    def device_trace(self) -> Optional[dict]:
        """The trace's reduction where the card ran something in the
        window; None untraced or without device events."""
        return self.trace if self.trace and self.trace["busy_s"] else None

    @property
    def n(self) -> int:
        return self.cell.n

    @property
    def nnz(self) -> int:
        """A's nonzeros, counted from the generated edges."""
        if self._nnz is None:
            self._nnz = distinct_nnz(self.cell.edges, self.cell.n)
        return self._nnz

    @property
    def adj_itemsize(self) -> int:
        return ITEMSIZE[self.cell.cfg["layout"]["dense_dtype"]]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(device: torch.device, chips: int, peak: int,
                trace: Optional[dict]) -> dict:
    if device.type == "cuda":
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=chips, memory_peak_bytes=peak)
    else:
        info = dict(platform="cpu", kind="cpu", count=chips,
                    memory_peak_bytes=peak)
    if trace is not None:
        info.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return info


def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t0: float, spec: Optional[dict] = None
             ) -> dict:
    """Runs cell ``name`` once; the result line's object."""
    spec = spec or load_spec(root)
    w = workload(spec, name)
    cfg = load_json(config_file(spec, root, w["config"]))
    bench = root / "benchmark"
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench / "limits" / f"{name}.json")
    cell = cells.make_cell(cfg, traffic, device, bench)
    cell.setup(seed)
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    setup_s = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s, of which "
          + ", ".join(f"{k} {v:.3f}" for k, v in cell.spans.items()),
          file=sys.stderr, flush=True)
    if traced:
        path = root / "build" / "bench_trace" / f"{name}.json"
        with tr.traced(path):
            stats = cell.window(min(seconds, traffic["trace_seconds"]))
        trace = tr.read_trace(path)
    else:
        stats, trace = cell.window(seconds), None
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.after_window()
    cell.free_program()
    correct, checks = judge(cell.numbers(), limits)
    run = Run(cell, stats, setup_s, trace)
    e2e = [m for m in spec["end_to_end"] if applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    wanted = (spec["per_layer"] if traced else spec["end_to_end"])
    metrics: Dict[str, dict] = {}
    for m in wanted:
        if not applies(m, name, reported):
            continue
        value = load_reader(m["name"], bench / "metrics")(run)
        if value is None:
            print(f"metric {m['name']}: nothing to read in {name}",
                  file=sys.stderr)
            continue
        metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    out = dict(correct=bool(correct and stats["failed"] == 0),
               attempted=int(stats["attempted"]), failed=int(stats["failed"]),
               metrics=metrics,
               device=device_info(device, w["chips"], int(peak), trace))
    if trace is not None:
        out["breakdown"] = dict(device_ops=trace["device_ops"],
                                idle_gaps=trace["idle_gaps"])
    out["checks"] = checks
    return out

"""What every cell shares, and the driver a traffic file names.

A traffic file (``benchmark/traffic/<mix>.json``) names its driver:
``benchmark/drivers/<driver>.py``, found by name, whose ``Driver`` is a
``Cell`` that sets up from a configuration file and the run's seed,
drives the program through the window, and works out the numbers that
decide ``correct``. A new kind of traffic is a driver file added.

After the window each cell reads the card's peak memory, frees the
program's state, and only then runs the reference: the module that the
configuration's ``reference`` names (``benchmark/reference/__init__.py``
lists what it defines).
"""

from __future__ import annotations

import gc
import time
from pathlib import Path, PurePosixPath
from types import ModuleType
from typing import Dict

import torch

from glass_tpu_torch import GLASS, build_graph

from benchmark import byname
from benchmark import generate as gen
from benchmark import trace as tr

BENCH = gen.BENCH
REFERENCES = PurePosixPath("benchmark/reference")


def out_channels(cfg: dict) -> int:
    """Logits per subgraph: one for a binary task (BCE), else a class
    each."""
    classes = cfg["subgraphs"]["classes"]
    return 1 if cfg["model"]["loss"] == "bce" and classes == 2 else classes


def reference(cfg: dict, bench: Path = BENCH) -> ModuleType:
    """The plain reference that the configuration's ``reference`` names: a
    ``.py`` file directly under ``benchmark/reference/``, loaded by name
    once a process."""
    path = PurePosixPath(cfg["reference"])
    if path.parent != REFERENCES or path.suffix != ".py":
        raise ValueError(f"{cfg['name']}: the reference {str(path)!r} is not "
                         f"a .py file directly under {REFERENCES}/")
    return byname.load(bench / "reference", path.stem)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Cell:
    """Shared set-up: the inputs from the seed and the program's graph,
    feature ids and model, with the benchmark's weights, and ``ref``, the
    configuration's plain reference. A driver sets ``mode``, the name the
    metrics' readers ask for."""

    mode = ""

    def __init__(self, cfg: dict, traffic: dict, device: torch.device,
                 bench: Path = BENCH):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.bench = bench
        self.ref = reference(cfg, bench)
        self.model_cfg = cfg["model"]
        self.spans: Dict[str, float] = {}  # set-up's parts, seconds
        self.program = None  # the objects the window drives
        self._since = time.perf_counter()

    def mark(self, part: str) -> None:
        """Records the seconds since the last mark as ``<part>_s``."""
        now = time.perf_counter()
        self.spans[f"{part}_s"] = now - self._since
        self._since = now

    def make_inputs(self, seed: int) -> None:
        """The edge list, feature ids and initial weights of ``seed``."""
        self.seed = seed
        self.edges, self.n = gen.make_graph(self.cfg["graph"], seed,
                                            self.bench)
        self.ids = gen.degree_ids(self.edges, self.n)
        self.out_channels = out_channels(self.cfg)
        self.shapes = self.ref.param_shapes(
            self.model_cfg, int(self.ids.max()), self.out_channels)
        self.weights = gen.make_weights(self.shapes, seed, self.device)
        self.mark("inputs")

    def draw_subgraphs(self, rng, count: int):
        return gen.draw_subgraphs(rng, count, self.cfg["subgraphs"],
                                  self.cfg["graph"], self.bench)

    def build_model(self):
        """The program's graph (timed as ``graph_build_s``), ids and GLASS
        carrying the benchmark's weights."""
        m, layout = self.model_cfg, self.cfg["layout"]
        t0 = time.perf_counter()
        with tr.span("graph_build"):
            graph = build_graph(
                self.edges, None, self.n, m["aggr"], materialize_dense=False,
                dense_dtype=layout["dense_dtype"], materialize_bcsr=True,
                sparse_layout=layout["sparse_layout"], device=self.device)
            sync(self.device)
        self.spans["graph_build_s"] = time.perf_counter() - t0
        self.plan = graph.plan
        x = torch.from_numpy(self.ids).to(self.device)
        model = GLASS(int(self.ids.max()), m["hidden_dim"], m["conv_layer"],
                      (self.out_channels,), (m["pool"],),
                      dropout=m["dropout"], activation=m["activation"],
                      z_ratio=m["z_ratio"], jk=m["jk"], spmm_mode="pallas",
                      compute_dtype=self.cfg["precision"]["compute_dtype"],
                      device=self.device)
        model.load_state_dict(self.weights, strict=True)
        self.mark("model")
        return graph, x, model

    def free_program(self) -> None:
        self.program = None
        _free()

    def reference_adjacency(self):
        return self.ref.Adjacency(
            torch.from_numpy(self.edges).to(self.device), self.n,
            self.model_cfg["aggr"])

    def after_window(self) -> None:
        """Runs once the window has closed and the peak is read, before the
        program's state is freed: what the check needs is kept."""

    # a driver's own: setup(seed), window(seconds) -> stats dict with
    # seconds, attempted and failed, and numbers(tf32=False) -> the
    # check's numbers against the reference


def driver(name: str, bench: Path = BENCH) -> type:
    """The ``Driver`` class of ``benchmark/drivers/<name>.py``."""
    return byname.load(bench / "drivers", name).Driver


def make_cell(cfg: dict, traffic: dict, device: torch.device,
              bench: Path = BENCH) -> Cell:
    return driver(traffic["driver"], bench)(cfg, traffic, device, bench)

"""tools/torch_max_scale.py, the port's scale ladder, on the CPU at a tiny
rung: its generator byte-equal to tools/max_scale.py's, one rung's record
line whole, and the rung's first 3 training losses against the JAX
Trainer on the same graph and parameters (dropout off, f32), within rtol
1e-4, the tolerance of tests/test_torch_train.py's Trainer parity tests;
and the build's memory: the numpy allocations' peak in each phase of a
rung's build, under tracemalloc, held to the lean design's bytes a
directed edge (MEMORY_BOUNDS). The card's rungs are in PERF.md."""

import importlib.util
import io
import json
import os
import sys
import tracemalloc
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glass_tpu.nn.modules import GLASS as FlaxGLASS
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.train import loop as jloop
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import Trainer, build_graph, params_from_flax
from glass_tpu_torch import native
from glass_tpu_torch.ops import bcsr_spmm

REPO = Path(__file__).resolve().parent.parent
SCALE = 0.02  # 8 communities: 1,024 nodes, 180,000 directed edges
LOSS_RTOL = 1e-4

sys.path.insert(0, str(REPO / "tools"))
import torch_max_scale as tms  # noqa: E402


@pytest.fixture
def jax_tool(monkeypatch):
    """tools/max_scale.py, loaded as a module; the compilation-cache
    variables it sets on import are restored after the test."""
    for key in ("JAX_COMPILATION_CACHE_DIR",
                "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"):
        monkeypatch.setenv(key, os.environ.get(key, ""))
    spec = importlib.util.spec_from_file_location(
        "jax_max_scale", REPO / "tools" / "max_scale.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scale", [SCALE, 0.05])
def test_generator_is_max_scales(jax_tool, scale):
    ei, n = tms.clustered_graph(scale)
    ref, n_ref = jax_tool.clustered_graph(scale)
    assert n == n_ref == int(448 * scale) * 128
    assert ei.dtype == ref.dtype and ei.shape == ref.shape
    assert ei.tobytes() == ref.tobytes()


RECORD_KEYS = {
    "scale", "dtype", "compute_dtype", "hidden", "fused_norm", "device", "card", "n_node",
    "directed_edges", "generate_s", "build_s", "build_csr_s", "build_plan_s",
    "build_fill_s", "build_other_s", "native", "kernel_rel_err",
    "kernel_rel_errs", "kernel_x_dtype", "sparse_layout", "plan", "layout",
    "layout_bytes", "layout_t_bytes", "layout_t_shared", "edge_array_bytes",
    "caps", "jax_budget_model_bytes", "remat", "graphed", "steps_lo",
    "steps_hi", "first_step_s", "ms_per_step", "steps_per_s", "edges_per_s",
    "losses", "last_epoch_losses", "host_peak_rss_bytes", "device_ms_per_step", "device_ms_by_kernel", "idle_share", "resident_bytes",
    "peak_allocated_bytes", "host_peak_by_phase", "digests"}


def test_one_rung_on_the_cpu_prints_every_field():
    """A rung in f32 without and with remat (the same losses), then a rung
    that fails: its line names the error and the walk goes on."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tms.main(["--scales", str(SCALE), "--dtype", "f32,bogus",
                       "--device", "cpu", "--steps", "4", "--hidden", "16",
                       "--remat_ab"])
    assert rc == 0
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    assert len(lines) == 3
    off, on, failed = lines
    for rec, remat in ((off, False), (on, True)):
        assert set(rec) == RECORD_KEYS, set(rec) ^ RECORD_KEYS
        assert rec["remat"] is remat and rec["graphed"] is False
        assert rec["n_node"] == 1024 and rec["directed_edges"] == 180_000
        assert rec["steps_hi"] == 4 and rec["steps_lo"] == 1
        assert rec["ms_per_step"] > 0 and rec["card"] is None
        assert rec["device_ms_per_step"] is None  # not measured on the CPU
        assert len(rec["losses"]) == 5 and np.isfinite(rec["losses"]).all()
        assert rec["edges_per_s"] == pytest.approx(
            2 * 180_000 / rec["ms_per_step"] * 1e3 / 1e9)
    assert off["losses"] == on["losses"]
    assert off["sparse_layout"] == "auto" and off["kernel_rel_err"] is None
    assert failed["dtype"] == "bogus" and "KeyError" in failed["failed"]


@pytest.mark.parametrize("layout", ["band", "bcsr"])
def test_forced_layout_rung(layout):
    """--layout hands build_graph its sparse_layout: the rung builds and
    trains on that layout."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tms.main(["--scales", str(SCALE), "--dtype", "int8",
                       "--device", "cpu", "--steps", "2", "--hidden", "16",
                       "--layout", layout])
    assert rc == 0
    (rec,) = [json.loads(s) for s in out.getvalue().splitlines()]
    assert set(rec) == RECORD_KEYS, set(rec) ^ RECORD_KEYS
    assert rec["sparse_layout"] == layout and rec["layout"]["kind"] == layout
    assert rec["compute_dtype"] == "bfloat16"
    assert rec["layout_bytes"] > 0 and np.isfinite(rec["losses"]).all()


def _chip_smoke_recipe(n_comm, csz, e, intra_frac, seed):
    """chip_smoke.py's own generator before it drew through the tool's."""
    rng = np.random.default_rng(seed)
    n = n_comm * csz
    intra = int(intra_frac * e)
    ci = rng.integers(0, n_comm, size=intra)
    src_i = ci * csz + rng.integers(0, csz, size=intra)
    dst_i = ci * csz + rng.integers(0, csz, size=intra)
    cx = rng.integers(0, n_comm - 1, size=e - intra)
    src_x = cx * csz + rng.integers(0, csz, size=e - intra)
    dst_x = (cx + 1) * csz + rng.integers(0, csz, size=e - intra)
    src = np.concatenate([src_i, src_x])
    dst = np.concatenate([dst_i, dst_x])
    return np.stack([np.concatenate([src, dst]),
                     np.concatenate([dst, src])]), n


@pytest.mark.parametrize("args", [(8, 128, 3000, 0.95, 6),
                                  (10, 128, 5000, 0.95, 9),
                                  (12, 128, 6000, 0.95, 5)])
def test_chip_smoke_generator_is_the_tools(args):
    """chip_smoke.py's clustered_graph at its small shapes and seeds draws
    the edges it drew with its own copy of the recipe."""
    import chip_smoke as cs

    ei, n = cs.clustered_graph(*args[:4], seed=args[4])
    ref, n_ref = _chip_smoke_recipe(*args)
    assert n == n_ref and ei.dtype == ref.dtype
    assert ei.tobytes() == ref.tobytes()


def test_first_losses_match_the_jax_trainer():
    ei, n = tms.clustered_graph(SCALE)
    x, pos, y = tms.rung_inputs(n, 3)
    jg = jax_build_graph(ei, None, n, "gcn", materialize_dense=False,
                         materialize_bcsr=True, dense_dtype="f32")
    tgraph = build_graph(ei, None, n, "gcn", materialize_dense=False,
                         materialize_bcsr=True, dense_dtype="f32",
                         device="cpu")
    model = tms.make_model(tgraph, 64, None, "cpu", dropout=0.0)
    spmm_mode = model.conv.conv_0.spmm_mode
    fm = FlaxGLASS(max_deg=tms.MAX_ID, hidden_channels=64,
                   num_layers=tms.LAYERS, output_channels=(2,),
                   pools=("size",), dropout=0.0, activation="elu",
                   z_ratio=0.75, jk=True, spmm_mode=spmm_mode)
    cfg = tms.train_config()
    jt = jloop.Trainer(fm, jg, jnp.asarray(x.astype(np.int32)),
                       jloop.TrainConfig(lr=cfg.lr, batch_size=cfg.batch_size,
                                         loss=cfg.loss, use_z=cfg.use_z),
                       donate=False)
    params, opt_state, plateau = jt.init(0, jnp.asarray(pos[0]))
    params_from_flax(model, _flatten(params))
    key = jax.random.PRNGKey(1)
    ref = []
    for p, t in zip(pos, y):  # one-step epochs: per-step losses
        params, opt_state, plateau, key, loss = jt.train_epoch(
            params, opt_state, plateau, key, jnp.asarray(p[None]),
            jnp.asarray(t[None]))
        ref.append(float(loss))
    trainer = Trainer(model, tgraph, torch.from_numpy(x), cfg)
    trainer.init(0)
    got = trainer.train_epoch(pos, y).step_losses
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)


class TracedPeaks:
    """tools/torch_max_scale.py's HostPeaks read from tracemalloc: the
    numpy allocations' peak in each phase of the build."""

    def __init__(self):
        self.peaks = {}
        self._name = None

    def phase(self, name):
        _, peak = tracemalloc.get_traced_memory()
        if self._name is not None:
            self.peaks[self._name] = max(self.peaks.get(self._name, 0), peak)
        tracemalloc.reset_peak()
        self._name = name


# Bytes a directed edge that each phase of the lean build may allocate in
# numpy at scale 0.05 (2,816 nodes, 450,000 directed edges, padded to
# 450,560), the generated edges aside (the caller's, dropped after the
# CSR). The design: the CSR's int32 row and col and f32 weights, 12 bytes
# an edge, live from the CSR on; the symmetry test adds its int32 column
# order (4); the planner works on the block pattern (a few bytes a block);
# the fill adds the f32 blocks (25.6 bytes an edge at this rung: 22 row
# blocks of 8 stored 128 x 128 blocks), and int8 its int8 copy (6.4) and
# one chunk's temporaries (2.3), the f32 blocks dropped before the copy.
# The comparisons and the quantization run in small batches here, as they
# do at the ladder's sizes. Measured (numpy 2.0.2): csr 12.1, widen 12.0,
# symmetry 16.2, plan 12.1, fill 37.7 (f32) and 46.5 (int8), copy 37.7 and
# 18.5. Each bound is about 2 bytes an edge above its measured peak: less
# than the 8 an int64 copy of the edges adds.
MEMORY_BOUNDS = {
    "f32": {"csr": 14, "widen": 14, "symmetry": 18, "plan": 14, "fill": 40,
            "copy": 40},
    "int8": {"csr": 14, "widen": 14, "symmetry": 18, "plan": 14, "fill": 48,
             "copy": 21},
}


@pytest.mark.parametrize("dtype, layout", [("f32", "auto"), ("int8", "bcsr")])
def test_build_memory_per_directed_edge(monkeypatch, dtype, layout):
    assert native.is_available()
    monkeypatch.setattr(bcsr_spmm, "SYM_BATCH", 1 << 12)
    monkeypatch.setattr(bcsr_spmm, "QUANT_BATCH", 1)
    ei, n = tms.clustered_graph(0.05)
    n_directed = ei.shape[1]
    edges = [ei]
    del ei
    peaks = TracedPeaks()
    tracemalloc.start()
    try:
        graph, rec = tms.build_rung(edges, n, dtype, 16, torch.device("cpu"),
                                    layout, peaks=peaks)
        peaks.phase(None)
    finally:
        tracemalloc.stop()
    assert graph.bcsr is not None and rec["native"]
    per_edge = {k: v / n_directed for k, v in peaks.peaks.items()}
    assert set(per_edge) == set(MEMORY_BOUNDS[dtype])
    over = {k: round(v, 2) for k, v in per_edge.items()
            if v > MEMORY_BOUNDS[dtype][k]}
    assert not over, f"bytes a directed edge past the bounds: {over}"


# layout_digests of the 0.05 rung on the forced BCSR layout, as the build
# before its lean rewrite gave them (the same tool's --digests on the CPU):
# the lean build's edge arrays and layouts byte-equal to that build's, and
# the digest format chip_smoke.py's LADDER_DIGESTS (rung 4, on the card)
# were taken in
SMALL_CSR_SHA256 = (
    "7fe4d504c400ed3e5f85efcc64aab989743ba9f133d8e48731b49b4cf3b9f403")
SMALL_BCSR_SHA256 = {
    "f32": "484e5148750857bdf374776738d4483b4e0024b74320434491a8389f29e5470e",
    "int8": "218751d4edd918ec78d3a61dd768e9e2ffb72d6a78af6644874042b598ea55ac",
}


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_small_rung_digests_are_the_previous_builds(dtype):
    ei, n = tms.clustered_graph(0.05)
    _, rec = tms.build_rung(ei, n, dtype, 16, torch.device("cpu"), "bcsr",
                            digests=True)
    bcsr = SMALL_BCSR_SHA256[dtype]
    assert rec["digests"] == dict(plan=None, csr=SMALL_CSR_SHA256, band=None,
                                  band_t=None, bcsr=bcsr, bcsr_t=bcsr,
                                  dense_q=None, dense_q_t=None)

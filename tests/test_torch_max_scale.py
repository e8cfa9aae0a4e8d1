"""tools/torch_max_scale.py, the port's scale ladder, on the CPU at a tiny
rung: its generator byte-equal to tools/max_scale.py's, one rung's record
line whole, and the rung's first 3 training losses against the JAX
Trainer on the same graph and parameters (dropout off, f32), within rtol
1e-4, the tolerance of tests/test_torch_train.py's Trainer parity tests.
The card's rungs are in PERF.md."""

import importlib.util
import io
import json
import os
import sys
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
    "peak_allocated_bytes"}


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

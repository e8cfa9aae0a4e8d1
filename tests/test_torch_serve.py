"""The port's Predictor against glass_tpu's, on a checkpoint written by
``glass_tpu.utils.checkpoint.save_checkpoint`` (tolerance rtol 1e-4,
atol 1e-5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.nn.modules import GLASS as FlaxGLASS
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.serve import Predictor as JaxPredictor
from glass_tpu.utils.checkpoint import save_checkpoint
from glass_tpu_torch import GLASS, Predictor, build_graph

N = 200
SUBS = [[0, 1, 2], [5, 6], [10, 11, 12, 13], [150, 40]]


@pytest.fixture
def setup(rng, tmp_path):
    src, dst = rng.integers(0, N, 600), rng.integers(0, N, 600)
    ei = np.stack([np.r_[src, dst], np.r_[dst, src]])
    kw = dict(materialize_bcsr=True, sparse_layout="bcsr")
    jg = jax_build_graph(ei, None, N, "gcn", **kw)
    tg = build_graph(ei, None, N, "gcn", device="cpu", **kw)
    x = rng.integers(0, 4, (N, 1))
    fm = FlaxGLASS(max_deg=3, hidden_channels=8, num_layers=1,
                   output_channels=(2,), pools=("size",), dropout=0.0,
                   activation="elu", z_ratio=0.75, jk=True, spmm_mode="pallas")
    params = fm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                     jnp.asarray([[0, 1, -1]]), None)
    path = tmp_path / "m.npz"
    save_checkpoint(path, params)

    def torch_model():
        return GLASS(3, 8, 1, (2,), ("size",), activation="elu",
                     z_ratio=0.75, jk=True, spmm_mode="pallas", seed=5,
                     device="cpu")

    return dict(fm=fm, jg=jg, tg=tg, x=x, params=params, path=path,
                torch_model=torch_model)


@pytest.mark.parametrize("use_z", [True, False])
def test_from_checkpoint_matches_jax_predictor(setup, use_z):
    s = setup
    ref = JaxPredictor(s["fm"], s["jg"], jnp.asarray(s["x"]), s["params"],
                       use_z=use_z)(SUBS)
    pred = Predictor.from_checkpoint(s["torch_model"](), s["tg"],
                                     torch.from_numpy(s["x"]), s["path"],
                                     use_z=use_z, device="cpu")
    out = pred(SUBS)
    assert isinstance(out, np.ndarray) and out.shape == (4, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_buckets_pad_like_jax(setup):
    """A request padded into a larger bucket gives the same logits as its
    rows served in a tight bucket (padding rows and columns are inert)."""
    s = setup
    pred = Predictor.from_checkpoint(s["torch_model"](), s["tg"],
                                     torch.from_numpy(s["x"]), s["path"],
                                     device="cpu")
    tight = Predictor(pred.model, s["tg"], torch.from_numpy(s["x"]),
                      batch_buckets=(4,), width_buckets=(4,), device="cpu")
    np.testing.assert_allclose(pred(SUBS), tight(SUBS), rtol=1e-5, atol=1e-6)


def test_bucket_overflow_raises(setup):
    s = setup
    pred = Predictor(s["torch_model"](), s["tg"], torch.from_numpy(s["x"]),
                     batch_buckets=(2,), width_buckets=(4,), device="cpu")
    pred([[0]])
    pred([[1], [2]])
    with pytest.raises(ValueError, match="exceeds"):
        pred([[0]] * 3)
    with pytest.raises(ValueError, match="exceeds"):
        pred([[0, 1, 2, 3, 4]])


def test_device_checks(setup, monkeypatch):
    s = setup
    with pytest.raises(ValueError, match="not on the predictor's device"):
        Predictor(s["torch_model"](), s["tg"],
                  torch.from_numpy(s["x"]).to("meta"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(s["torch_model"](), s["tg"], torch.from_numpy(s["x"]))


# ------------------------------------------ the per-bucket programs vs JAX

BUCKETS = [(b, w) for b in (1, 8, 64) for w in (16, 64)]
LAYOUTS = {"bcsr": ("bcsr", "f32"), "band": ("band", "f32"),
           "int8_band": ("band", "int8")}


def bucket_request(rng, b: int, w: int, n: int = N):
    """b subgraphs (so the batch bucket is b) of 1..w nodes, the first of w
    (so the width bucket is w)."""
    sizes = [w] + list(rng.integers(1, w + 1, b - 1))
    return [rng.choice(n, int(k), replace=False).tolist() for k in sizes]


@pytest.mark.parametrize("use_z", [True, False])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_bucket_programs_match_jax_predictor(rng, tmp_path, layout, use_z):
    """Requests in every (batch, width) bucket of (1, 8, 64) x (16, 64) on
    BCSR, band and int8-band layouts: the port's Predictor (its per-bucket
    programs, eager on the CPU) against glass_tpu's (one jit a bucket, its
    Pallas kernels in interpret mode), rtol 1e-4, atol 1e-5."""
    sparse_layout, dense_dtype = LAYOUTS[layout]
    src, dst = rng.integers(0, N, 600), rng.integers(0, N, 600)
    ei = np.stack([np.r_[src, dst], np.r_[dst, src]])
    kw = dict(materialize_bcsr=True, sparse_layout=sparse_layout,
              dense_dtype=dense_dtype)
    jg = jax_build_graph(ei, None, N, "gcn", **kw)
    tg = build_graph(ei, None, N, "gcn", device="cpu", **kw)
    held = tg.band if sparse_layout == "band" else tg.bcsr
    assert held is not None
    assert ((held.slabs if sparse_layout == "band" else held.blocks).dtype
            == (torch.int8 if dense_dtype == "int8" else torch.float32))
    x = rng.integers(0, 4, (N, 1))
    fm = FlaxGLASS(max_deg=3, hidden_channels=8, num_layers=2,
                   output_channels=(2,), pools=("size",), dropout=0.0,
                   activation="elu", z_ratio=0.75, jk=True, spmm_mode="pallas")
    params = fm.init(jax.random.PRNGKey(1), jg, jnp.asarray(x),
                     jnp.asarray([[0, 1, -1]]), None)
    save_checkpoint(tmp_path / "m.npz", params)
    ref = JaxPredictor(fm, jg, jnp.asarray(x), params, use_z=use_z)
    model = GLASS(3, 8, 2, (2,), ("size",), activation="elu", z_ratio=0.75,
                  jk=True, spmm_mode="pallas", device="cpu")
    pred = Predictor.from_checkpoint(model, tg, torch.from_numpy(x),
                                     tmp_path / "m.npz", use_z=use_z,
                                     device="cpu")
    for b, w in BUCKETS:
        subs = bucket_request(rng, b, w)
        out = pred(subs)
        assert out.shape == (b, 2)
        np.testing.assert_allclose(out, ref(subs), rtol=1e-4, atol=1e-5,
                                   err_msg=f"bucket ({b}, {w})")
    assert set(pred._programs.programs) == set(BUCKETS)


def test_program_cache_has_one_entry_a_bucket(setup, rng):
    """One program a (batch, width) bucket, keyed on the bucket and never on
    the request's own size; on the CPU each runs eagerly (no graph)."""
    s = setup
    pred = Predictor(s["torch_model"](), s["tg"], torch.from_numpy(s["x"]),
                     device="cpu")
    assert not pred._graphed and pred._stream is None
    first = pred([[0, 1, 2]])
    for subs in ([[0, 1, 2]], [[3]], [[0, 1], [2, 3, 4]], [[1]] * 8,
                 [list(range(20))]):
        pred(subs)
    assert set(pred._programs.programs) == {(1, 16), (8, 16), (1, 64)}
    assert all(p.graph is None for p in pred._programs.programs.values())
    np.testing.assert_array_equal(pred([[0, 1, 2]]), first)
    # the bucket's host buffer is refilled: no stale node of a wider request
    wide, narrow = [list(range(12))], [[0, 1]]
    pred(wide)
    np.testing.assert_array_equal(
        pred(narrow), Predictor(pred.model, s["tg"], torch.from_numpy(s["x"]),
                                device="cpu")(narrow))

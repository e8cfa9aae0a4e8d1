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

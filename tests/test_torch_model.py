"""The port's GLASS against glass_tpu's flax GLASS with the same weights.

Flax params from ``GLASS.init`` are flattened as glass_tpu checkpoints
flatten them, carried across with ``params_from_flax``, and both models run
on the same graph, features, batch and labels. The "pallas" cases run the
JAX Pallas BCSR kernel in interpret mode and the port's plain version of its
CUDA kernel. Tolerance: rtol 1e-4, atol 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.nn.modules import GLASS as FlaxGLASS
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.ops.labeling import max_zero_one as jax_max_zero_one
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import GLASS, build_graph, params_from_flax

N_NODE, MAX_DEG, HIDDEN, LAYERS = 300, 7, 16, 2
GRAPH_KW = dict(materialize_dense=True, materialize_bcsr=True,
                sparse_layout="bcsr")


def make_inputs(rng):
    src, dst = rng.integers(0, N_NODE, 1000), rng.integers(0, N_NODE, 1000)
    ei = np.stack([np.r_[src, dst], np.r_[dst, src]])
    x = rng.integers(0, MAX_DEG + 1, (N_NODE, 1))
    pos = np.full((5, 12), -1, np.int64)
    for i in range(4):  # the last row is batch padding
        k = int(rng.integers(2, 13))
        pos[i, :k] = rng.choice(N_NODE, k, replace=False)
    return ei, x, pos


def flax_model(jk, mode, pool, out=(3,)):
    return FlaxGLASS(max_deg=MAX_DEG, hidden_channels=HIDDEN,
                     num_layers=LAYERS, output_channels=out, pools=(pool,),
                     dropout=0.0, activation="elu", z_ratio=0.8, jk=jk,
                     spmm_mode=mode)


def torch_model(jk, mode, pool, out=(3,), seed=0):
    return GLASS(MAX_DEG, HIDDEN, LAYERS, out, (pool,), activation="elu",
                 z_ratio=0.8, jk=jk, spmm_mode=mode, seed=seed, device="cpu")


@pytest.mark.parametrize("jk, mode, pool, use_z", [
    (True, "pallas", "size", True),
    (False, "pallas", "mean", True),
    (True, "dense", "max", True),
    (False, "dense", "sum", True),
    (True, "pallas", "size", False),  # z=None: the all-TRUE mask quirk
])
def test_glass_matches_flax(rng, jk, mode, pool, use_z):
    ei, x, pos = make_inputs(rng)
    jg = jax_build_graph(ei, None, N_NODE, "gcn", **GRAPH_KW)
    tg = build_graph(ei, None, N_NODE, "gcn", device="cpu", **GRAPH_KW)
    z = jax_max_zero_one(jnp.asarray(pos), N_NODE) if use_z else None
    fm = flax_model(jk, mode, pool)
    params = fm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                     jnp.asarray(pos), z)
    ref = np.asarray(fm.apply(params, jg, jnp.asarray(x), jnp.asarray(pos), z))

    tm = params_from_flax(torch_model(jk, mode, pool), _flatten(params))
    with torch.no_grad():
        out = tm(tg, torch.from_numpy(x), torch.from_numpy(pos),
                 None if z is None else torch.from_numpy(np.array(z)))
    assert out.shape == ref.shape == (5, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def flax_params(rng):
    ei, x, pos = make_inputs(rng)
    jg = jax_build_graph(ei, None, N_NODE, "gcn", materialize_dense=True)
    fm = flax_model(True, "dense", "size")
    return _flatten(fm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                            jnp.asarray(pos), None))


def test_params_from_flax_raises_on_missing_key(rng):
    flat = flax_params(rng)
    del flat["/params/conv/conv_1/comb_0/bias"]
    with pytest.raises(KeyError, match="conv.conv_1.comb_0.bias"):
        params_from_flax(torch_model(True, "dense", "size"), flat)


def test_params_from_flax_raises_on_unexpected_key_and_shape(rng):
    flat = flax_params(rng)
    flat["/params/pred_1/bias"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="pred_1.bias"):
        params_from_flax(torch_model(True, "dense", "size"), flat)
    del flat["/params/pred_1/bias"]
    with pytest.raises(ValueError, match="shape"):
        params_from_flax(torch_model(True, "dense", "size", out=(2,)), flat)


def test_params_from_flax_maps_every_leaf(rng):
    flat = flax_params(rng)
    tm = params_from_flax(torch_model(True, "dense", "size"), flat)
    state = tm.state_dict()
    assert len(state) == len(flat)
    np.testing.assert_array_equal(
        state["conv.conv_0.trans_1.weight"].numpy(),
        flat["/params/conv/conv_0/trans_1/kernel"].T)
    np.testing.assert_array_equal(state["conv.input_emb.weight"].numpy(),
                                  flat["/params/conv/input_emb/embedding"])


def test_init_is_seeded_and_torch_distributed():
    a = torch_model(True, "dense", "size", seed=3).state_dict()
    b = torch_model(True, "dense", "size", seed=3).state_dict()
    c = torch_model(True, "dense", "size", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pred_0.weight"], c["pred_0.weight"])
    bound = 1 / np.sqrt(HIDDEN)
    assert a["conv.conv_0.trans_1.weight"].abs().max() <= bound
    assert torch.equal(a["conv.gn_out.mean_scale"], torch.ones(HIDDEN * LAYERS))


def test_training_and_missing_card_raise(monkeypatch, rng):
    ei, x, pos = make_inputs(rng)
    tg = build_graph(ei, None, N_NODE, "gcn", device="cpu")
    with pytest.raises(NotImplementedError, match="training"):
        torch_model(True, "dense", "size")(tg, torch.from_numpy(x),
                                           torch.from_numpy(pos), training=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GLASS(MAX_DEG, HIDDEN, LAYERS, (1,), ("size",))


def test_pallas_mode_refuses_autograd(rng):
    ei, x, pos = make_inputs(rng)
    tg = build_graph(ei, None, N_NODE, "gcn", device="cpu", **GRAPH_KW)
    tm = torch_model(True, "pallas", "size")
    with pytest.raises(RuntimeError, match="autograd"):
        tm(tg, torch.from_numpy(x), torch.from_numpy(pos))

"""The port's GLASS against glass_tpu's flax GLASS with the same weights.

Flax params from ``GLASS.init`` are flattened as glass_tpu checkpoints
flatten them, carried across with ``params_from_flax``, and both models run
on the same graph, features, batch and labels. The "pallas" cases run the
JAX Pallas BCSR kernel in interpret mode and the port's plain version of its
CUDA kernel. Tolerance: rtol 1e-4, atol 1e-5. With
``compute_dtype="bfloat16"`` (flax ``dtype="bfloat16"``): logits within
atol 1e-2 * max|logit|, the tightest bound that held over seeds 0-4 on the
four layouts of ``BF16_GRAPHS`` (measured at most 8.2e-3 * max|logit|:
bf16 rounds at other places in the two frameworks); the JAX package holds
its own bf16 mode to rtol 0.1, atol 0.05 of f32
(tests/test_mixed_precision.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.nn.modules import GLASS as FlaxGLASS
from glass_tpu.nn.modules import GLASSConv as FlaxGLASSConv
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.ops.labeling import max_zero_one as jax_max_zero_one
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import GLASS, build_graph, params_from_flax
from glass_tpu_torch.nn.modules import GLASSConv
from glass_tpu_torch.utils.checkpoint import _torch_key

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


BF16_GRAPHS = {  # name: (graph kwargs, dense_dtype, spmm mode)
    "dense_f32": (dict(materialize_dense=True), "f32", "dense"),
    "band_int8": (dict(materialize_dense=False, materialize_bcsr=True,
                       sparse_layout="band"), "int8", "pallas"),
    "bcsr_bf16": (dict(materialize_dense=False, materialize_bcsr=True,
                       sparse_layout="bcsr"), "bf16", "pallas"),
    "dense_int8": (dict(materialize_dense=True), "int8", "dense"),
}


@pytest.mark.parametrize("config", sorted(BF16_GRAPHS))
def test_glass_bf16_compute_matches_flax(rng, config):
    kw, dense_dtype, mode = BF16_GRAPHS[config]
    ei, x, pos = make_inputs(rng)
    jg = jax_build_graph(ei, None, N_NODE, "gcn", dense_dtype=dense_dtype,
                         **kw)
    tg = build_graph(ei, None, N_NODE, "gcn", dense_dtype=dense_dtype,
                     device="cpu", **kw)
    z = jax_max_zero_one(jnp.asarray(pos), N_NODE)
    fm = FlaxGLASS(max_deg=MAX_DEG, hidden_channels=HIDDEN,
                   num_layers=LAYERS, output_channels=(3,), pools=("size",),
                   dropout=0.0, activation="elu", z_ratio=0.8, jk=True,
                   spmm_mode=mode, dtype="bfloat16")
    params = fm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                     jnp.asarray(pos), z)
    ref = np.asarray(fm.apply(params, jg, jnp.asarray(x), jnp.asarray(pos), z))
    tm = params_from_flax(
        GLASS(MAX_DEG, HIDDEN, LAYERS, (3,), ("size",), activation="elu",
              z_ratio=0.8, jk=True, spmm_mode=mode, compute_dtype="bfloat16",
              device="cpu"), _flatten(params))
    with torch.no_grad():
        out = tm(tg, torch.from_numpy(x), torch.from_numpy(pos),
                 torch.from_numpy(np.array(z)))
    assert out.dtype == torch.float32  # the head takes the pooled rows in f32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())


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


def test_params_from_flax_carries_a_dropout_model(rng):
    """Dropout adds no parameter: a flax GLASS built with dropout loads into
    the port's GLASS built with the same rates, every leaf mapped."""
    ei, x, pos = make_inputs(rng)
    jg = jax_build_graph(ei, None, N_NODE, "gcn", materialize_dense=True)
    fm = FlaxGLASS(max_deg=MAX_DEG, hidden_channels=HIDDEN, num_layers=LAYERS,
                   output_channels=(3,), pools=("size",), dropout=0.5,
                   activation="elu", z_ratio=0.8, jk=True)
    flat = _flatten(fm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                            jnp.asarray(pos), None))
    tm = params_from_flax(
        GLASS(MAX_DEG, HIDDEN, LAYERS, (3,), ("size",), dropout=0.5,
              conv_dropout=0.2, device="cpu"), flat)
    assert len(tm.state_dict()) == len(flat)


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
    """Training with dropout needs an explicit generator; an unknown
    compute dtype raises, bf16 (ported) builds with f32 parameters; a
    missing card raises."""
    ei, x, pos = make_inputs(rng)
    tg = build_graph(ei, None, N_NODE, "gcn", device="cpu")
    model = GLASS(MAX_DEG, HIDDEN, LAYERS, (3,), ("size",), dropout=0.3,
                  device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        model(tg, torch.from_numpy(x), torch.from_numpy(pos), training=True)
    out = model(tg, torch.from_numpy(x), torch.from_numpy(pos), training=True,
                generator=torch.Generator().manual_seed(0))
    assert out.shape == (5, 3) and out.requires_grad
    bf16 = GLASS(MAX_DEG, HIDDEN, LAYERS, (1,), ("size",),
                 compute_dtype="bfloat16", device="cpu")
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        GLASS(MAX_DEG, HIDDEN, LAYERS, (1,), ("size",),
              compute_dtype="float16", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GLASS(MAX_DEG, HIDDEN, LAYERS, (1,), ("size",))


def test_pallas_mode_refuses_autograd(rng):
    """The block-sparse kernels differentiate in x, never in the layout: a
    layout that requires grad is refused."""
    ei, x, pos = make_inputs(rng)
    tg = build_graph(ei, None, N_NODE, "gcn", device="cpu", **GRAPH_KW)
    leafy = dataclasses.replace(
        tg.bcsr, blocks=tg.bcsr.blocks.clone().requires_grad_())
    tg = dataclasses.replace(tg, bcsr=leafy, bcsr_t=leafy)
    tm = torch_model(True, "pallas", "size")
    with pytest.raises(RuntimeError, match="autograd"):
        tm(tg, torch.from_numpy(x), torch.from_numpy(pos))


GRAD_GRAPHS = {
    "dense": dict(materialize_dense=True),
    "bcsr": dict(materialize_dense=False, materialize_bcsr=True,
                 sparse_layout="bcsr"),
    "band": dict(materialize_dense=False, materialize_bcsr=True,
                 sparse_layout="band"),
}


def grad_graphs(rng, layout):
    """An asymmetric ("mean") graph in both packages, so the block-sparse
    backward runs over its own transposed layout."""
    ei, x, pos = make_inputs(rng)
    kw = GRAD_GRAPHS[layout]
    jg = jax_build_graph(ei, None, N_NODE, "mean", **kw)
    tg = build_graph(ei, None, N_NODE, "mean", device="cpu", **kw)
    return jg, tg, x, pos


@pytest.mark.parametrize("layout", sorted(GRAD_GRAPHS))
def test_glass_parameter_gradients_match_flax(rng, layout):
    jg, tg, x, pos = grad_graphs(rng, layout)
    mode = "dense" if layout == "dense" else "pallas"
    z = jax_max_zero_one(jnp.asarray(pos), N_NODE)
    fm = flax_model(True, mode, "size")
    params = fm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                     jnp.asarray(pos), z)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    grads = _flatten(jax.grad(lambda p: (fm.apply(
        p, jg, jnp.asarray(x), jnp.asarray(pos), z) * w).sum())(params))

    tm = params_from_flax(torch_model(True, mode, "size"), _flatten(params))
    out = tm(tg, torch.from_numpy(x), torch.from_numpy(pos),
             torch.from_numpy(np.array(z)))
    (out * torch.from_numpy(w)).sum().backward()
    tgrads = dict(tm.named_parameters())
    assert len(tgrads) == len(grads)
    for key, g in grads.items():
        name, transpose = _torch_key(key)
        ref = g.T if transpose else g
        np.testing.assert_allclose(tgrads[name].grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("layout", sorted(GRAD_GRAPHS))
def test_glass_conv_input_gradient_matches_flax(rng, layout):
    jg, tg, _, pos = grad_graphs(rng, layout)
    mode = "dense" if layout == "dense" else "pallas"
    x = rng.normal(size=(N_NODE, HIDDEN)).astype(np.float32)
    w = rng.normal(size=(N_NODE, HIDDEN)).astype(np.float32)
    mask = np.array(jax_max_zero_one(jnp.asarray(pos), N_NODE) > 0)[:, None]
    fc = FlaxGLASSConv(out_channels=HIDDEN, z_ratio=0.8, dropout=0.0,
                       activation="elu", spmm_mode=mode)
    params = fc.init(jax.random.PRNGKey(1), jg, jnp.asarray(x), mask)
    ref = np.asarray(jax.grad(lambda v: (fc.apply(
        params, jg, v, mask) * w).sum())(jnp.asarray(x)))

    conv = params_from_flax(
        GLASSConv(HIDDEN, HIDDEN, z_ratio=0.8, activation="elu",
                  spmm_mode=mode, dropout=0.0,
                  generator=torch.Generator().manual_seed(0)),
        _flatten(params))
    xt = torch.from_numpy(x).requires_grad_()
    (conv(tg, xt, torch.from_numpy(mask)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())

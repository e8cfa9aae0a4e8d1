"""The port's SSL pretraining modules and data against glass_tpu's, on the
CPU (``glass_tpu_torch/nn/pretrain.py``, ``nn/modules.py::MLP``,
``data/basegraph.py::get_lp_dataset``, ``build_graph(add_self_loops=)``).

Flax parameters from ``init`` are flattened as glass_tpu checkpoints
flatten them and carried across with ``params_from_flax``; both packages
run the same graph and inputs, made from a numpy seed, in f32 with TF32
off and dropout 0. The "pallas" mode runs the JAX Pallas kernels in
interpret mode and the port's plain versions of its CUDA kernels.
Tolerances: outputs within 1e-5 x max|out|; the BCE loss's parameter
gradients (``jax.grad``) each within 1e-4 x its own max|grad| plus
1e-5 x the largest leaf's (a bias ahead of a GraphNorm whose mean scale is
1 has a zero gradient, its values rounding noise that no bound of its own
can hold); graphs and the link-prediction dataset equal array for array.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu import native as jnative
from glass_tpu.data.basegraph import BaseGraphData as JaxBase
from glass_tpu.nn import pretrain as jpre
from glass_tpu.nn.modules import MLP as FlaxMLP
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.train.loop import bce_with_logits as jax_bce
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import native as tnative
from glass_tpu_torch.data.basegraph import BaseGraphData
from glass_tpu_torch.nn import pretrain as tpre
from glass_tpu_torch.nn.modules import MLP
from glass_tpu_torch.ops.graph import build_graph
from glass_tpu_torch.train.loop import bce_with_logits
from glass_tpu_torch.utils.checkpoint import params_from_flax, params_to_flax

# both planners under the JAX planner's constants (autouse)
from test_torch_planner import (assert_graph_layouts_equal,  # noqa: F401
                                jax_planner_constants)

N_NODE, HIDDEN, LAYERS = 300, 16, 3
OUT_TOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-5
MODES = ("dense", "segment", "pallas")
AGGRS = ("sum", "mean", "gcn")
# both builders: the dense matrix and a BCSR layout ("pallas" reads it)
GRAPH_KW = dict(materialize_dense=True, materialize_bcsr=True,
                sparse_layout="bcsr")


def undirected_edges(rng, n=N_NODE, e=1500, loops=0):
    """A symmetric (2, E) edge list of two clusters, no duplicates, with
    ``loops`` self-loops."""
    half = n // 2
    a = rng.integers(0, half, (2, e // 2))
    b = rng.integers(half, n, (2, e // 2))
    ei = np.concatenate([a, b], axis=1)
    ei = ei[:, ei[0] != ei[1]]
    if loops:
        v = rng.choice(n, loops, replace=False)
        ei = np.concatenate([ei, np.stack([v, v])], axis=1)
    both = np.concatenate([ei, ei[::-1]], axis=1)
    return np.unique(both.T, axis=0).T.copy()


def graphs(ei, aggr, n=N_NODE, **kw):
    kw = {**GRAPH_KW, **kw}
    return (jax_build_graph(ei, None, n, aggr, **kw),
            build_graph(ei, None, n, aggr, device="cpu", **kw))


def close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"max|diff| {err} > {tol} * {scale}"


# ------------------------------------------------------------------ MLP

@pytest.mark.parametrize("num_layers", [1, 2, 3])
@pytest.mark.parametrize("gn", [False, True])
@pytest.mark.parametrize("tail", [False, True])
def test_mlp_matches_flax(rng, num_layers, gn, tail):
    x = rng.normal(size=(40, 12)).astype(np.float32) * 2 + 0.5
    fm = FlaxMLP(hidden_channels=HIDDEN, output_channels=5,
                 num_layers=num_layers, dropout=0.0, tail_activation=tail,
                 activation="relu", gn=gn)
    params = fm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = np.asarray(fm.apply(params, jnp.asarray(x)))
    tm = MLP(12, HIDDEN, 5, num_layers, tail_activation=tail, gn=gn,
             generator=torch.Generator().manual_seed(0))
    params_from_flax(tm, _flatten(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    close(out.numpy(), ref, OUT_TOL)
    # the flax tree and the port's parameters map one to one, both ways
    flat = _flatten(params)
    back = params_to_flax(tm)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))


# ------------------------------------------------------- the conv layers

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("aggr", AGGRS)
def test_my_gcn_conv_matches_flax(rng, mode, aggr):
    ei = undirected_edges(rng)
    jg, tg = graphs(ei, aggr)
    x = rng.normal(size=(N_NODE, HIDDEN)).astype(np.float32)
    fm = jpre.MyGCNConv(out_channels=8, activation="relu", spmm_mode=mode)
    params = fm.init(jax.random.PRNGKey(1), jg, jnp.asarray(x))
    ref = np.asarray(fm.apply(params, jg, jnp.asarray(x)))
    tm = tpre.MyGCNConv(HIDDEN, 8, activation="relu", spmm_mode=mode,
                        generator=torch.Generator().manual_seed(0))
    params_from_flax(tm, _flatten(params))
    with torch.no_grad():
        out = tm(tg, torch.from_numpy(x))
    close(out.numpy(), ref, OUT_TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("jk", [False, True])
def test_emb_gconv_matches_flax(rng, mode, jk):
    ei = undirected_edges(rng)
    jg, tg = graphs(ei, "mean")
    max_deg = 9
    x = rng.integers(0, max_deg + 1, N_NODE)
    fm = jpre.EmbGConv(hidden_channels=HIDDEN, output_channels=8,
                       num_layers=LAYERS, max_deg=max_deg, dropout=0.0,
                       activation="relu", jk=jk, spmm_mode=mode)
    params = fm.init(jax.random.PRNGKey(2), jg, jnp.asarray(x))
    ref = np.asarray(fm.apply(params, jg, jnp.asarray(x)))
    tm = tpre.EmbGConv(HIDDEN, 8, LAYERS, max_deg, dropout=0.0,
                       activation="relu", jk=jk, gn=True, spmm_mode=mode,
                       generator=torch.Generator().manual_seed(0))
    params_from_flax(tm, _flatten(params))
    with torch.no_grad():
        out = tm(tg, torch.from_numpy(x))
    assert out.shape == (N_NODE, HIDDEN * (LAYERS - 1) + 8 if jk else 8)
    close(out.numpy(), ref, OUT_TOL)


# ---------------------------------------------------------------- EdgeGNN

def edge_gnn_pair(rng, mode, aggr, jk, layout="bcsr"):
    """(flax model, its params, port model with them, jax graph, port
    graph, x, pos, y) on a nodeid feature (the protocol's default)."""
    ei = undirected_edges(rng)
    jg, tg = graphs(ei, aggr, sparse_layout=layout)
    x = np.arange(N_NODE).reshape(N_NODE, 1)
    pos = np.concatenate([ei[:, :40].T, rng.integers(0, N_NODE, (40, 2))])
    y = np.r_[np.ones(40), np.zeros(40)].astype(np.float32)
    kw = dict(hidden_channels=HIDDEN, num_layers=LAYERS, dropout=0.0,
              activation="relu", jk=jk, spmm_mode=mode)
    fm = jpre.EdgeGNN(max_deg=N_NODE - 1, **kw)
    params = fm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                     jnp.asarray(pos[:2]))
    tm = tpre.EdgeGNN(N_NODE - 1, HIDDEN, LAYERS, dropout=0.0,
                      activation="relu", jk=jk, spmm_mode=mode, device="cpu")
    params_from_flax(tm, _flatten(params))
    return fm, params, tm, jg, tg, x, pos, y


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("aggr", AGGRS)
@pytest.mark.parametrize("jk", [False, True])
def test_edge_gnn_matches_flax(rng, mode, aggr, jk):
    fm, params, tm, jg, tg, x, pos, _ = edge_gnn_pair(rng, mode, aggr, jk)
    ref = np.asarray(fm.apply(params, jg, jnp.asarray(x), jnp.asarray(pos)))
    emb_ref = np.asarray(fm.apply(params, jg, jnp.asarray(x),
                                  method=jpre.EdgeGNN.node_emb))
    with torch.no_grad():
        out = tm(tg, torch.from_numpy(x), torch.from_numpy(pos))
        emb = tm.node_emb(tg, torch.from_numpy(x))
    assert out.shape == (len(pos), 1)
    assert emb.shape == (N_NODE, HIDDEN * (LAYERS if jk else 1))
    close(out.numpy(), ref, OUT_TOL)
    close(emb.numpy(), emb_ref, OUT_TOL)


@pytest.mark.parametrize("mode, aggr, jk, layout", [
    ("dense", "mean", False, "bcsr"),
    ("segment", "gcn", True, "bcsr"),
    ("segment", "sum", False, "bcsr"),
    ("pallas", "mean", False, "bcsr"),
    ("pallas", "gcn", True, "bcsr"),
    ("pallas", "mean", True, "band"),  # the asymmetric band pair
])
def test_edge_gnn_gradients_match_jax(rng, mode, aggr, jk, layout):
    fm, params, tm, jg, tg, x, pos, y = edge_gnn_pair(rng, mode, aggr, jk,
                                                      layout)
    if layout == "band":
        assert tg.band is not None and tg.band_t is not tg.band

    def loss_of(p):
        return jax_bce(fm.apply(p, jg, jnp.asarray(x), jnp.asarray(pos)),
                       jnp.asarray(y))

    ref_loss, ref_grads = jax.value_and_grad(loss_of)(params)
    loss = bce_with_logits(tm(tg, torch.from_numpy(x), torch.from_numpy(pos)),
                           torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-6)
    ref_flat = _flatten(ref_grads)
    with torch.no_grad():  # the gradients, laid out as flax leaves
        for p in tm.parameters():
            p.copy_(p.grad)
    grads = params_to_flax(tm)
    assert sorted(grads) == sorted(ref_flat)
    # each leaf within GRAD_TOL of its own max|grad|, plus a floor of
    # GRAD_FLOOR x the largest leaf's for leaves whose exact gradient is
    # zero (a bias ahead of a GraphNorm), which hold only rounding
    scale = max(float(np.abs(np.asarray(g)).max()) for g in ref_flat.values())
    for key, g_ref in ref_flat.items():
        g_ref = np.asarray(g_ref)
        err = float(np.abs(grads[key] - g_ref).max())
        bound = GRAD_TOL * float(np.abs(g_ref).max()) + GRAD_FLOOR * scale
        assert err <= bound, (key, err, bound)


# ------------------------------------------------------- the graph builder

@pytest.mark.parametrize("aggr", AGGRS)
@pytest.mark.parametrize("weighted", [False, True])
def test_build_graph_with_self_loops_matches_jax(rng, aggr, weighted):
    ei = undirected_edges(rng, loops=7)  # some nodes have a loop already
    w = (rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
         if weighted else None)
    kw = dict(add_self_loops=True, **GRAPH_KW)
    jg = jax_build_graph(ei, w, N_NODE, aggr, **kw)
    tg = build_graph(ei, w, N_NODE, aggr, device="cpu", **kw)
    assert tg.n_edge == jg.n_edge == ei.shape[1] + N_NODE
    np.testing.assert_array_equal(tg.row.numpy(), np.asarray(jg.row))
    np.testing.assert_array_equal(tg.col.numpy(), np.asarray(jg.col))
    np.testing.assert_array_equal(tg.weight.numpy(), np.asarray(jg.weight))
    assert_graph_layouts_equal(tg, jg)
    plain = build_graph(ei, w, N_NODE, aggr, device="cpu")
    assert tg.n_edge == plain.n_edge + N_NODE


# ------------------------------------------- the link-prediction dataset

def bases(ei, n=N_NODE):
    kw = dict(x=np.zeros((n, 1), np.int64), edge_index=ei,
              edge_weight=np.ones(ei.shape[1], np.float32),
              pos=np.zeros((1, 2), np.int64), y=np.zeros(1),
              mask=np.zeros(1, np.int64))
    return JaxBase(**kw), BaseGraphData(**kw)


@pytest.mark.parametrize("branch", ["native", "numpy", "too_dense"])
@pytest.mark.parametrize("use_loop", [False, True])
def test_lp_dataset_matches_jax(monkeypatch, rng, branch, use_loop):
    n = N_NODE
    if branch == "too_dense":  # fewer non-edges than edges: native refuses
        n = 24
        full = np.array([(a, b) for a in range(n) for b in range(n)
                         if a != b and (a + b) % 5]).T
        ei = np.concatenate([full, np.array([[0, 3], [0, 3]])], axis=1)
    else:
        ei = undirected_edges(rng, loops=5)
    if branch == "numpy":
        monkeypatch.setattr(tnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        assert tnative.is_available() and jnative.is_available()
    jb, tb = bases(ei, n)
    seed = 11
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    pos_j, y_j = jb.get_lp_dataset(rj, use_loop=use_loop)
    pos_t, y_t = tb.get_lp_dataset(rt, use_loop=use_loop)
    for a, b in ((pos_t, pos_j), (y_t, y_j)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the same draws were taken: both generators stand at the same state
    assert rt.bit_generator.state == rj.bit_generator.state
    e = tb.edge_index.shape[1]
    np.testing.assert_array_equal(pos_t[:e], tb.edge_index.T)
    neg = pos_t[e:len(pos_t) - (n if use_loop else 0)]
    keys = set(map(tuple, tb.edge_index.T))
    assert not any(tuple(p) in keys or p[0] == p[1] for p in neg)
    assert len(set(map(tuple, neg))) == len(neg)
    if branch == "too_dense":
        assert len(neg) < e  # the graph has no more non-edges
    else:
        assert len(neg) == e

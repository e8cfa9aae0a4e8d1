"""The port's GNN-seg data and model against glass_tpu's, on the CPU
(``glass_tpu_torch/data/khop.py``, ``data/seg.py``, ``native.py::
induced_subgraph_adj``, ``nn/seg.py``, ``utils/checkpoint.py``).

The same numpy inputs, made from a seed, go through both packages:

- ``k_hop_subgraph``: every output equal, hops 0-2, relabelled or not;
- ``induced_subgraph_adj``: byte-equal to ``glass_tpu.native``'s on raw
  edge lists with repeated edges (both count each repeat);
- ``segregate``: every array byte-equal, through the native branch and
  through the numpy branch, for the "one" and "deg" features;
- ``GSegGNN`` from JAX's initial parameters, the norms' drawn at random
  (converted by ``params_from_flax``): logits within rtol 1e-5 (and 1e-6 x max|logit|
  absolute, for entries near 0), every parameter's gradient within
  1e-4 x its own max |grad|, gcn and gin, 1 and 3 layers; the parameters
  written back by ``params_to_flax`` equal JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu import native as jnative
from glass_tpu.data import khop as jkhop
from glass_tpu.data import seg as jseg
from glass_tpu.data.basegraph import BaseGraphData as JaxBase
from glass_tpu.nn.seg import GSegGNN as FlaxGSegGNN
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import native as tnative
from glass_tpu_torch.data import khop as tkhop
from glass_tpu_torch.data import seg as tseg
from glass_tpu_torch.data.basegraph import BaseGraphData
from glass_tpu_torch.nn.seg import GSegGNN
from glass_tpu_torch.utils.checkpoint import params_from_flax, params_to_flax

LOGIT_RTOL, LOGIT_ATOL_REL, GRAD_TOL = 1e-5, 1e-6, 1e-4


def random_edges(rng, n, e):
    """A directed (2, e) edge list with repeats and self-loops."""
    return rng.integers(0, n, (2, e))


def bases(seed=0, n=60, n_sub=24, edge_index=None):
    """(JAX, port) BaseGraphData of one random dataset: subgraphs of 1-9
    nodes (one of 9 sets L), split 0/1/2 at random, two classes."""
    rng = np.random.default_rng(seed)
    ei = random_edges(rng, n, 4 * n) if edge_index is None else edge_index
    sizes = rng.integers(1, 10, n_sub)
    sizes[0] = 9
    pos = np.full((n_sub, 9), -1, np.int64)
    for i, k in enumerate(sizes):
        pos[i, :k] = rng.choice(n, k, replace=False)
    mask = rng.permutation(np.arange(n_sub) % 3)
    kw = dict(x=np.zeros((n, 1), np.int64), edge_index=ei,
              edge_weight=np.ones(ei.shape[1], np.float32), pos=pos,
              y=(sizes > 5).astype(np.int64), mask=mask)
    return JaxBase(**kw), BaseGraphData(**kw)


@pytest.mark.parametrize("hops", [0, 1, 2])
@pytest.mark.parametrize("relabel", [True, False])
def test_k_hop_subgraph_matches_jax(hops, relabel):
    rng = np.random.default_rng(hops)
    n = 80
    ei = random_edges(rng, n, 160)
    seeds = rng.choice(n, 6, replace=False)
    want = jkhop.k_hop_subgraph(seeds, hops, ei, n, relabel_nodes=relabel)
    got = tkhop.k_hop_subgraph(seeds, hops, ei, n, relabel_nodes=relabel)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("seed", [0, 1])
def test_induced_subgraph_adj_matches_jax_native(seed):
    assert tnative.is_available() and jnative.is_available()
    rng = np.random.default_rng(seed)
    n = 50
    ei = random_edges(rng, n, 400)
    ei = np.concatenate([ei, ei[:, :40]], axis=1)  # 40 edges twice
    pos = np.full((12, 10), -1, np.int64)
    for i in range(12):
        k = rng.integers(1, 11)
        pos[i, :k] = rng.choice(n, k, replace=False)
    want = jnative.induced_subgraph_adj(ei, n, pos)
    got = tnative.induced_subgraph_adj(ei, n, pos)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert want.max() >= 2.0  # a repeated edge between members


def test_induced_subgraph_adj_refuses_foreign_ids():
    ei = np.array([[0, 1], [1, 0]])
    with pytest.raises(ValueError, match="pos"):
        tnative.induced_subgraph_adj(ei, 2, np.array([[0, 2]]))
    with pytest.raises(ValueError, match="edge_index"):
        tnative.induced_subgraph_adj(np.array([[0], [5]]), 2,
                                     np.array([[0, 1]]))


def assert_splits_equal(want: dict, got: dict):
    assert set(got) == set(want) == {"train", "valid", "test"}
    for split in want:
        for field in ("feats", "adj_norm", "adj_sum", "mask", "y"):
            w, g = getattr(want[split], field), getattr(got[split], field)
            assert g.dtype == w.dtype and g.shape == w.shape, (split, field)
            assert g.tobytes() == w.tobytes(), (split, field)


@pytest.mark.parametrize("branch", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["one", "deg"])
@pytest.mark.parametrize("edges", ["random", "issue"])
def test_segregate_is_byte_equal(monkeypatch, branch, kind, edges):
    ei = (np.array([[0, 0, 1, 1, 2, 2], [1, 1, 0, 0, 2, 0]])
          if edges == "issue" else None)
    jb, tb = bases(seed=3, edge_index=ei, n=60)
    if branch == "numpy":
        monkeypatch.setattr(jnative, "induced_subgraph_adj",
                            lambda *a: None)
        monkeypatch.setattr(tnative, "induced_subgraph_adj",
                            lambda *a: None)
    else:
        assert tnative.is_available() and jnative.is_available()
    want, got = jseg.segregate(jb, kind), tseg.segregate(tb, kind)
    assert_splits_equal(want, got)
    assert want["train"].adj_sum.any() or edges == "issue"


def test_segregate_branches_agree():
    _, tb = bases(seed=4)
    pos = tb.pos
    native = tnative.induced_subgraph_adj(tb.edge_index, tb.n_node, pos)
    np.testing.assert_array_equal(
        native, tseg._induced_adj_numpy(tb, pos, pos.shape[1]))


def model_inputs(seed=5):
    jb, _ = bases(seed=seed, n=80, n_sub=30)
    d = jseg.segregate(jb, "deg")["train"]
    return d.adj_norm, d.adj_sum, d.feats, d.mask


def flax_and_port(conv, layers, inputs, hidden=8, out=3):
    an, asum, f, m = inputs
    fm = FlaxGSegGNN(hidden_channels=hidden, output_channels=out,
                     num_layers=layers, dropout=0.0, activation="elu",
                     conv=conv)
    params = fm.init(jax.random.PRNGKey(layers), jnp.asarray(an),
                     jnp.asarray(asum), jnp.asarray(f), jnp.asarray(m))
    # the norms' initial mean_scale of 1 cancels the conv bias before
    # them, whose gradient is then rounding noise: draw the norms' leaves
    rng = np.random.default_rng(layers)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.3 * rng.standard_normal(a.shape),
                                        a.dtype)
        if "gn_" in jax.tree_util.keystr(path) else a, params)
    tm = GSegGNN(f.shape[-1], hidden, out, layers, dropout=0.0, conv=conv,
                 device="cpu")
    params_from_flax(tm, _flatten(params))
    return fm, params, tm


@pytest.mark.parametrize("conv", ["gcn", "gin"])
@pytest.mark.parametrize("layers", [1, 3])
def test_gseg_forward_and_gradients_match_jax(conv, layers):
    inputs = model_inputs()
    fm, params, tm = flax_and_port(conv, layers, inputs)
    j_in = [jnp.asarray(a) for a in inputs]
    t_in = [torch.from_numpy(a) for a in inputs]
    want = np.asarray(fm.apply(params, *j_in))
    got = tm(*t_in).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL_REL * np.abs(want).max())

    w = np.random.default_rng(6).standard_normal(want.shape).astype(np.float32)
    grads = _flatten(jax.grad(
        lambda p: (fm.apply(p, *j_in) * w).sum())(params))
    tm.zero_grad()
    (tm(*t_in) * torch.from_numpy(w)).sum().backward()
    port = {k: v.grad for k, v in tm.named_parameters()}
    flat_port = params_to_flax(tm)
    assert set(grads) == set(flat_port)
    for key, g in grads.items():
        name = key.strip("/").split("/", 1)[1].replace("/", ".")
        name = name.replace("kernel", "weight")
        got_g = port[name].numpy()
        got_g = got_g.T if key.endswith("kernel") else got_g
        scale = np.abs(g).max()
        assert np.abs(got_g - g).max() <= GRAD_TOL * scale, (key, scale)


@pytest.mark.parametrize("conv", ["gcn", "gin"])
def test_gseg_checkpoint_round_trips(conv):
    inputs = model_inputs()
    _, params, tm = flax_and_port(conv, 2, inputs)
    want = _flatten(params)
    got = params_to_flax(tm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_padded_rows_are_written_as_in_jax():
    """MaskedGraphNorm and the GCN bias write padded rows; only the pool
    masks them, so the trunk's activations agree on every row."""
    from glass_tpu.nn.seg import MaskedGraphNorm as FlaxNorm
    from glass_tpu_torch.nn.seg import MaskedGraphNorm

    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 7, 5)).astype(np.float32)
    m = np.zeros((4, 7), bool)
    m[:, :3] = True
    fn = FlaxNorm()
    p = fn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(m))
    p = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape), a.dtype), p)
    want = np.asarray(fn.apply(p, jnp.asarray(x), jnp.asarray(m)))
    tn = MaskedGraphNorm(5)
    params_from_flax(tn, _flatten(p))
    got = tn(torch.from_numpy(x), torch.from_numpy(m)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=1e-6)
    assert np.abs(got[:, 3:]).max() > 0

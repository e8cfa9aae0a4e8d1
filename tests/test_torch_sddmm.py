"""The port's SDDMM, segment softmax, ``AttentionConv`` and small helpers
against glass_tpu's, on the CPU (``glass_tpu_torch/ops/sddmm.py``,
``nn/modules.py::AttentionConv``, ``ops/norm.py::graph_size_norm``,
``ops/labeling.py``).

The same numpy inputs, made from a seed, go through both packages, on the
same graph (both builders give the same padded edge arrays, held first):

- ``sddmm`` in both modes (and the automatic choice) and
  ``segment_softmax`` (padding edges weight 0; a row with no edges; rows
  one score far above the rest): within 1e-5 x max |JAX result|;
- ``AttentionConv`` from JAX's initial parameters (``params_from_flax``):
  the output and every parameter's and the input's gradient within 1e-5
  x its own max |JAX value|;
- ``graph_size_norm``: within 1 f32 rounding (rtol 1e-7); ``pad2batch``
  and ``batch2pad``: equal to JAX's, and round trips.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.nn.modules import AttentionConv as FlaxAttentionConv
from glass_tpu.ops import labeling as jlabel
from glass_tpu.ops import norm as jnorm
from glass_tpu.ops.sddmm import sddmm as jax_sddmm
from glass_tpu.ops.sddmm import segment_softmax as jax_segment_softmax
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch.nn.modules import AttentionConv
from glass_tpu_torch.ops import labeling as tlabel
from glass_tpu_torch.ops import norm as tnorm
from glass_tpu_torch.ops import sddmm as tsddmm
from glass_tpu_torch.ops.graph import build_graph
from glass_tpu_torch.utils.checkpoint import params_from_flax

TOL = 1e-5  # times max |JAX result|


def graphs(seed=0, n=120, e=600):
    """(JAX Graph, port Graph) of one random undirected "gcn" graph whose
    last node has no edges, with its padding edges."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n - 1, (2, e))
    ei = np.concatenate([ei, ei[::-1]], axis=1)
    jg = jax_build_graph(ei, None, n, "gcn")
    tg = build_graph(ei, None, n, "gcn", device="cpu")
    for name in ("row", "col", "weight"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    assert (tg.weight == 0).any(), "no padding edges"
    return jg, tg


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("mode", ["dense", "gather", None])
@pytest.mark.parametrize("same", [True, False])
def test_sddmm_matches_jax(mode, same):
    jg, tg = graphs()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((tg.n_node, 16)).astype(np.float32)
    y = None if same else rng.standard_normal(x.shape).astype(np.float32)
    want = jax_sddmm(jg, jnp.asarray(x), None if same else jnp.asarray(y),
                     mode)
    got = tsddmm.sddmm(tg, torch.from_numpy(x),
                       None if same else torch.from_numpy(y), mode)
    close(got, want)


def test_sddmm_refuses_unknown_mode():
    _, tg = graphs()
    with pytest.raises(ValueError, match="sddmm mode"):
        tsddmm.sddmm(tg, torch.zeros(tg.n_node, 2), mode="csr")


@pytest.mark.parametrize("spike", [False, True])
def test_segment_softmax_matches_jax(spike):
    jg, tg = graphs(seed=2)
    scores = np.random.default_rng(3).standard_normal(
        tg.row.shape[0]).astype(np.float32)
    if spike:  # one score per touched row far above its row's rest
        scores[::7] += 60.0
    want = np.asarray(jax_segment_softmax(jg, jnp.asarray(scores)))
    got = tsddmm.segment_softmax(tg, torch.from_numpy(scores)).numpy()
    close(got, want)
    assert (got[tg.weight.numpy() == 0] == 0).all()
    sums = np.zeros(tg.n_node)
    np.add.at(sums, tg.row.numpy(), got)
    has_edge = np.bincount(tg.row.numpy()[tg.weight.numpy() != 0],
                           minlength=tg.n_node) > 0
    np.testing.assert_allclose(sums[has_edge], 1.0, rtol=1e-5)
    assert not has_edge[-1]


def test_attention_conv_matches_jax():
    jg, tg = graphs(seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((tg.n_node, 12)).astype(np.float32)
    fm = FlaxAttentionConv(out_channels=8)
    params = fm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x))
    tm = AttentionConv(12, 8, generator=torch.Generator().manual_seed(0))
    params_from_flax(tm, _flatten(params))
    want = np.asarray(fm.apply(params, jg, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(tg, xt)
    close(got, want)

    w = rng.standard_normal(want.shape).astype(np.float32)
    jgrads, jdx = jax.grad(lambda p, v: (fm.apply(p, jg, v) * w).sum(),
                           argnums=(0, 1))(params, jnp.asarray(x))
    (got * torch.from_numpy(w)).sum().backward()
    close(xt.grad, jdx)
    port = dict(tm.named_parameters())
    for key, g in _flatten(jgrads).items():
        name = key.strip("/").split("/", 1)[1].replace("/", ".")
        if key.endswith("kernel"):
            close(port[name.replace("kernel", "weight")].grad.T, g)
        else:
            close(port[name].grad, g)


def test_graph_size_norm_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((9, 5)).astype(np.float32)
    counts = np.array([0, 1, 2, 3, 5, 8, 13, 21, 0.5], np.float32)
    want = np.asarray(jnorm.graph_size_norm(jnp.asarray(x), jnp.asarray(counts)))
    got = tnorm.graph_size_norm(torch.from_numpy(x), torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("pad", [
    [[0, 2, 3], [1, 4, 5], [6, 7, -1]],
    [[4, -1, -1], [0, 1, 2], [3, 5, -1], [6, -1, -1]],
    np.zeros((0, 3), np.int64),
])
def test_pad2batch_and_batch2pad_match_jax(pad):
    want_b, want_p = jlabel.pad2batch(pad)
    got_b, got_p = tlabel.pad2batch(pad)
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_p, want_p)
    batch = np.full(int(np.max(pad, initial=-1)) + 1, -1)
    batch[got_p] = got_b
    back, want_back = tlabel.batch2pad(batch), jlabel.batch2pad(batch)
    assert back.dtype == want_back.dtype
    np.testing.assert_array_equal(back, want_back)
    if len(pad):  # rows sorted, none empty: the round trip gives pad back
        np.testing.assert_array_equal(back, pad)

"""The port's main-path ops against glass_tpu's: max_zero_one, the four
pools, graph_norm and the three unsharded spmm modes (tolerance 1e-6)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.ops import graph as jgraph
from glass_tpu.ops import labeling as jlab
from glass_tpu.ops import norm as jnorm
from glass_tpu.ops import segment as jseg
from glass_tpu.ops.spmm import spmm as jax_spmm
from glass_tpu_torch.ops import graph as tgraph
from glass_tpu_torch.ops import labeling as tlab
from glass_tpu_torch.ops import norm as tnorm
from glass_tpu_torch.ops import segment as tseg
from glass_tpu_torch.ops import spmm as tspmm

TOL = dict(rtol=1e-6, atol=1e-6)


def padded_pos(rng, n, b=6, width=9):
    """(b, width) subgraph node matrix padded with -1; the last row is all
    padding (a right-padded request batch)."""
    pos = np.full((b, width), -1, np.int64)
    for i in range(b - 1):
        k = int(rng.integers(1, width + 1))
        pos[i, :k] = rng.choice(n, k, replace=False)
    return pos


def test_max_zero_one_matches(rng):
    n = 50
    pos = padded_pos(rng, n)
    ref = np.asarray(jlab.max_zero_one(jnp.asarray(pos), n))
    out = tlab.max_zero_one(torch.from_numpy(pos), n)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.sum() == len(set(pos[pos >= 0].tolist()))


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "size"])
def test_pool_subgraphs_matches(rng, kind):
    n = 40
    emb = rng.normal(size=(n, 7)).astype(np.float32)
    pos = padded_pos(rng, n)
    ref = np.asarray(jseg.pool_subgraphs(jnp.asarray(emb), jnp.asarray(pos), kind))
    out = tseg.pool_subgraphs(torch.from_numpy(emb), torch.from_numpy(pos), kind)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert not out[-1].any()  # all-(-1) row pools to 0


def test_pool_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown pool"):
        tseg.pool_subgraphs(torch.zeros(3, 2), torch.zeros(1, 2, dtype=torch.long), "min")


def test_graph_norm_matches(rng):
    x = (rng.normal(size=(300, 16)) * 3 + 1).astype(np.float32)
    w, b, ms = (rng.normal(size=16).astype(np.float32) for _ in range(3))
    ref = np.asarray(jnorm.graph_norm(*map(jnp.asarray, (x, w, b, ms))))
    out = tnorm.graph_norm(*map(torch.from_numpy, (x, w, b, ms)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_graph_norm_refuses_bf16():
    with pytest.raises(NotImplementedError, match="item 7"):
        tnorm.graph_norm(torch.zeros(4, 2, dtype=torch.bfloat16),
                         torch.ones(2), torch.zeros(2), torch.ones(2))


@pytest.fixture
def graphs(rng):
    n = 260
    src, dst = rng.integers(0, n, 800), rng.integers(0, n, 800)
    ei = np.stack([np.r_[src, dst], np.r_[dst, src]])
    kw = dict(materialize_dense=True, materialize_bcsr=True,
              sparse_layout="bcsr")
    jg = jgraph.build_graph(ei, None, n, "gcn", **kw)
    tg = tgraph.build_graph(ei, None, n, "gcn", device="cpu", **kw)
    return jg, tg, n


@pytest.mark.parametrize("mode", ["dense", "segment", "pallas"])
def test_spmm_modes_match(rng, graphs, mode):
    jg, tg, n = graphs
    x = rng.normal(size=(n, 24)).astype(np.float32)
    ref = np.asarray(jax_spmm(jg, jnp.asarray(x), mode))
    out = tspmm.spmm(tg, torch.from_numpy(x), mode)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_spmm_default_mode(rng, graphs):
    _, tg, n = graphs
    x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    torch.testing.assert_close(tspmm.spmm(tg, x), tspmm.spmm(tg, x, "dense"))


def test_spmm_refuses_what_the_graph_lacks(rng):
    n = 30
    ei = rng.integers(0, n, (2, 60))
    g = tgraph.build_graph(ei, None, n, "sum", materialize_dense=False,
                           device="cpu")
    x = torch.zeros(n, 2)
    with pytest.raises(ValueError, match="materialize_bcsr"):
        tspmm.spmm(g, x, "pallas")
    with pytest.raises(ValueError, match="dense adjacency"):
        tspmm.spmm(g, x, "dense")
    with pytest.raises(NotImplementedError, match="not ported"):
        tspmm.spmm(g, x, "band")
    with pytest.raises(ValueError, match="unknown spmm mode"):
        tspmm.spmm(g, x, "csr")

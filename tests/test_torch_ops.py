"""The port's main-path ops against glass_tpu's: max_zero_one, the four
pools, graph_norm and the three unsharded spmm modes (tolerance 1e-6); the
bf16 pools and spmm modes within one bf16 ulp (bf16 sums rounded in
another order). The four pools in f32 and bf16, values and gradients, bit
for bit against the form whose padding slots all gathered row 0
(``test_torch_pool.py``), and the padding spread over the rows."""

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
# both planners under the JAX planner's constants (autouse)
from test_torch_planner import jax_planner_constants  # noqa: F401
from test_torch_pool import (bit_equal, padded_batch, pool_and_grad,
                             pool_row0, summed_in_order)

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


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "size"])
def test_pool_subgraphs_bf16_matches(rng, kind):
    """bf16 embeddings pool in bf16, mask and counts in bf16 too."""
    n = 40
    emb = rng.normal(size=(n, 7)).astype(np.float32)
    pos = padded_pos(rng, n)
    ref = jseg.pool_subgraphs(jnp.asarray(emb).astype(jnp.bfloat16),
                              jnp.asarray(pos), kind)
    out = tseg.pool_subgraphs(torch.from_numpy(emb).to(torch.bfloat16),
                              torch.from_numpy(pos), kind)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


# (n, b, width): b x width slots over n rows, more rows than slots and
# fewer (serving's largest buckets: 256 x 250 slots over 57,333 rows)
POOL_CASES = {"rows_past_slots": (6000, 40, 128),
              "slots_past_rows": (300, 40, 128)}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", tseg.POOL_KINDS)
def test_pool_bit_equal_to_row0(kind, dtype, case):
    """Values and gradients bit-equal to the pool whose padding slots all
    gathered row 0, over nodes repeated across subgraphs and rows that are
    all padding (the CPU's sums in a fixed order)."""
    n, b, width = POOL_CASES[case]
    pos = padded_batch(np.random.default_rng(n), n, b, width,
                       empty=(3, 17, 39))
    real = pos[pos >= 0]
    assert np.unique(real).size < real.size  # nodes in several subgraphs
    assert (pos.size > n) == (case == "slots_past_rows")
    pos = torch.from_numpy(pos)
    gen = torch.Generator().manual_seed(9)
    emb = torch.randn(n, 24, generator=gen).to(dtype)
    dy = torch.randn(b, 24, generator=gen).to(dtype)
    with summed_in_order(torch.device("cpu")):
        out, grad = pool_and_grad(tseg.pool_subgraphs, emb, pos, kind, dy)
        want, want_grad = pool_and_grad(pool_row0, emb, pos, kind, dy)
    assert out.dtype == dtype and grad.dtype == dtype
    assert bit_equal(out, want) and bit_equal(grad, want_grad)
    assert not out[[3, 17, 39]].any()


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_gather_index_spreads_the_padding(case):
    """Real slots gather their node; no row takes more than ceil(B L / n)
    padding slots."""
    n, b, width = POOL_CASES[case]
    pos = torch.from_numpy(padded_batch(np.random.default_rng(3), n, b,
                                        width))
    idx = tseg.gather_index(pos.int(), n)
    assert idx.dtype == torch.int64 and idx.shape == pos.shape
    mask = pos >= 0
    assert torch.equal(idx[mask], pos[mask])
    assert idx.min() >= 0 and idx.max() < n
    per_row = torch.bincount(idx[~mask], minlength=n)
    assert per_row.max() <= -(-pos.numel() // n)
    assert int(per_row.sum()) == int((~mask).sum())


def test_pool_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown pool"):
        tseg.pool_subgraphs(torch.zeros(3, 2), torch.zeros(1, 2, dtype=torch.long), "min")


def test_graph_norm_matches(rng):
    x = (rng.normal(size=(300, 16)) * 3 + 1).astype(np.float32)
    w, b, ms = (rng.normal(size=16).astype(np.float32) for _ in range(3))
    ref = np.asarray(jnorm.graph_norm(*map(jnp.asarray, (x, w, b, ms))))
    out = tnorm.graph_norm(*map(torch.from_numpy, (x, w, b, ms)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_graph_norm_refuses_bf16(rng):
    """bf16, once refused, is ported: f32 statistics, bf16 result, equal to
    the JAX bf16 path within one bf16 ulp; other dtypes are refused."""
    x = (rng.normal(size=(300, 16)) * 3 + 1).astype(np.float32)
    w, b, ms = (rng.normal(size=16).astype(np.float32) for _ in range(3))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jnorm.graph_norm(xb, *map(jnp.asarray, (w, b, ms))),
                     dtype=np.float32)
    out = tnorm.graph_norm(torch.from_numpy(x).to(torch.bfloat16),
                           *map(torch.from_numpy, (w, b, ms)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -8,
                               atol=1e-6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tnorm.graph_norm(torch.zeros(4, 2, dtype=torch.float64),
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


@pytest.mark.parametrize("dense_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["dense", "segment", "pallas"])
def test_spmm_modes_bf16_x_return_f32(rng, mode, dense_dtype):
    """bf16 x on bf16 and int8 adjacencies: every mode returns f32, as the
    JAX dispatch's preferred_element_type gives it, equal to JAX within
    1e-5 * max (f32 sums of exact products in another order)."""
    n = 260
    src, dst = rng.integers(0, n, 800), rng.integers(0, n, 800)
    ei = np.stack([np.r_[src, dst], np.r_[dst, src]])
    kw = dict(materialize_dense=True, materialize_bcsr=True,
              sparse_layout="bcsr", dense_dtype=dense_dtype)
    jg = jgraph.build_graph(ei, None, n, "gcn", **kw)
    tg = tgraph.build_graph(ei, None, n, "gcn", device="cpu", **kw)
    assert (tg.dense_q is not None) == (dense_dtype == "int8")
    x = jnp.asarray(rng.normal(size=(n, 24)).astype(np.float32)).astype(
        jnp.bfloat16)
    ref = np.asarray(jax_spmm(jg, x, mode))
    out = tspmm.spmm(tg, torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16), mode)
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    if mode == "dense":  # mode None takes the dense (or int8 dense) layout
        assert torch.equal(out, tspmm.spmm(tg, torch.from_numpy(
            np.asarray(x, np.float32)).to(torch.bfloat16)))


def test_spmm_pallas_takes_the_band(rng):
    """A graph built with the band layout sends "pallas" to the band kernel,
    as the JAX dispatch does."""
    n = 6 * 128
    src = rng.integers(0, n, 1500)
    dst = np.clip(src + rng.integers(-100, 100, 1500), 0, n - 1)
    ei = np.stack([np.r_[src, dst], np.r_[dst, src]])
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout="band")
    jg = jgraph.build_graph(ei, None, n, "gcn", **kw)
    tg = tgraph.build_graph(ei, None, n, "gcn", device="cpu", **kw)
    assert tg.band is not None and tg.bcsr is None
    x = rng.normal(size=(n, 24)).astype(np.float32)
    ref = np.asarray(jax_spmm(jg, jnp.asarray(x), "pallas"))
    out = tspmm.spmm(tg, torch.from_numpy(x), "pallas")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert torch.equal(out, tspmm.spmm(tg, torch.from_numpy(x), "band"))


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
    with pytest.raises(ValueError, match="sparse_layout='band'"):
        tspmm.spmm(g, x, "band")
    with pytest.raises(ValueError, match="sparse_layout='hybrid'"):
        tspmm.spmm(g, x, "hybrid")
    # the ring is the sharded path's: it needs partition_graph's buckets
    with pytest.raises(ValueError, match="ring=True"):
        tspmm.spmm(g, x, "ring")
    with pytest.raises(ValueError, match="unknown spmm mode"):
        tspmm.spmm(g, x, "csr")

"""The port's graph partition (``glass_tpu_torch/parallel/partition.py``) and
its per-shard layouts against ``glass_tpu.parallel.partition``, on the CPU.

Both planners score with the JAX planner's constants and terms
(test_torch_planner's fixture), so that they choose the same layouts.

- The host arrays byte for byte, K in {2, 4}: the edge buckets (off-block,
  own-block and ring buckets, with and without the overlap split), the
  dense row blocks, and the stacked BCSR, band and hybrid layouts at f32,
  bf16 and int8 (blocks and slabs, their index tables, the window starts,
  the trim offsets g_lo, the int8 scales and every static). The port keeps
  the band's int8 scales as one f32 value of bf16 per row, where JAX keeps
  them lane-broadcast in bf16: ``row_scale[..., 0]`` is compared. The port
  pads exactly where JAX pads, and keeps two tables JAX does not:
  ``block_row_ptr`` and ``block_row_end``, which must mark the pad row
  block (the padding chunks' target) empty.
- Each shard's rectangular BCSR and trimmed band through the port's plain
  version against JAX's Pallas kernel in interpret mode on the same
  layout (``pg.bcsr.local(...)`` of one shard's slices, as
  tests/test_parallel.py:575-620 feeds them), forward and transposed,
  within 1e-5 x max|JAX|; and the shards' forward outputs stacked, and the
  transposed outputs summed, against the unsharded A @ x and A^T g.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.ops import pallas_band as jband
from glass_tpu.ops import pallas_spmm as jbcsr
from glass_tpu.parallel import partition as jpart
from glass_tpu_torch.ops import band_spmm as tband
from glass_tpu_torch.ops import bcsr_spmm as tbcsr
from glass_tpu_torch.ops import graph as tgraph
from glass_tpu_torch.ops.graph import normalized_edge_weight
from glass_tpu_torch.parallel import partition as tpart
# both planners under the JAX planner's constants (autouse)
from test_torch_planner import jax_planner_constants  # noqa: F401

B = 128
N = 9 * B + 37  # n % (K * 128) != 0: the last block is padded


def edges(seed=0, n=N):
    """A banded symmetric graph with far edges between the first and the
    last blocks (a hybrid residue) and repeated edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 5000)
    dst = np.clip(src + rng.integers(-150, 150, src.size), 0, n - 1)
    far_s, far_d = rng.integers(0, 80, 40), n - 1 - rng.integers(0, 80, 40)
    s, d = np.r_[src, far_s, src[:50]], np.r_[dst, far_d, dst[:50]]
    return np.stack([np.r_[s, d], np.r_[d, s]])


def as_numpy(a):
    """An array of either package as numpy (bf16 as its bits)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def assert_same(t, j, what):
    t, j = as_numpy(t), as_numpy(j)
    assert t.dtype == j.dtype and t.shape == j.shape, \
        (what, t.dtype, j.dtype, t.shape, j.shape)
    assert np.array_equal(t, j), what


def assert_same_bcsr(t, j, what):
    for name in ("blocks", "block_col", "chunk_start", "chunk_len",
                 "chunk_row", "chunk_first", "chunk_last"):
        assert_same(getattr(t, name), getattr(j, name), f"{what}.{name}")
    assert (t.n_rb, t.n_cb, t.n_node) == (j.n_rb, j.n_cb, j.n_node), what
    assert (t.row_scale is None) == (j.row_scale is None), what
    if t.row_scale is not None:
        assert_same(t.row_scale, j.row_scale, f"{what}.row_scale")
    # the port's tables: the pad row block empty, padding never live
    ptr, end = t.block_row_ptr, t.block_row_end
    assert np.array_equal(end[:, -1], ptr[:, -2]) and \
        np.array_equal(ptr[:, -1], ptr[:, -2]), what
    assert (end >= ptr[:, :-1]).all() and (end <= ptr[:, 1:]).all(), what


def assert_same_band(t, j, what):
    for name in ("slabs", "clo", "g_lo"):
        assert_same(getattr(t, name), getattr(j, name), f"{what}.{name}")
    for name in ("n_rb", "n_cb", "n_node", "rps", "w_blocks", "n_g_total",
                 "trimmed"):
        assert getattr(t, name) == getattr(j, name), (what, name)
    assert (t.row_scale is None) == (j.row_scale is None), what
    if t.row_scale is not None:
        want = np.asarray(j.row_scale[..., 0], np.float32).reshape(
            j.row_scale.shape[0], -1)
        assert_same(t.row_scale, want, f"{what}.row_scale")


def both(ei, k, **kw):
    return (tpart.partition_graph(ei, None, N, "gcn", k, **kw),
            jpart.partition_graph(ei, None, N, "gcn", k, **kw))


EDGE_ARRAYS = ("row", "col", "weight", "loc_row", "loc_col", "loc_weight",
               "ring_row", "ring_col", "ring_weight", "dense")


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("split", ["all_gather", "overlap", "ring"])
def test_edge_buckets_match(k, split):
    kw = dict(overlap=split != "all_gather", ring=split == "ring",
              materialize_dense=True)
    t, j = both(edges(), k, **kw)
    for name in EDGE_ARRAYS:
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert_same(a, b, name)
    assert (t.n_shards, t.block, t.n_node, t.n_edge, t.aggr) == \
        (j.n_shards, j.block, j.n_node, j.n_edge, j.aggr)
    x = np.arange(N * 2).reshape(N, 2)
    np.testing.assert_array_equal(t.pad_nodes(x), j.pad_nodes(x))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("layout", ["bcsr", "band", "hybrid"])
@pytest.mark.parametrize("k", [2, 4])
def test_stacked_layouts_match(k, layout, dtype):
    t, j = both(edges(), k, materialize_bcsr=True, sparse_layout=layout,
                dense_dtype=dtype)
    for name in ("bcsr", "bcsr_t", "band", "band_t"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        if name.startswith("bcsr"):
            assert_same_bcsr(a, b, name)
        else:
            assert_same_band(a, b, name)
    assert (t.band is not None) == (layout != "bcsr")
    assert (t.bcsr is not None) == (layout != "band")


@pytest.mark.parametrize("k", [2, 4])
def test_auto_plan_matches(k):
    """sparse_layout='auto' picks what JAX's stacked planner picks."""
    t, j = both(edges(), k, materialize_bcsr=True)
    for name in ("bcsr", "band"):
        assert (getattr(t, name) is None) == (getattr(j, name) is None)
    if t.band is not None:
        assert (t.band.rps, t.band.w_blocks, t.band_t.w_blocks) == \
            (j.band.rps, j.band.w_blocks, j.band_t.w_blocks)


def test_stacked_planner_prices_the_slab_rows(monkeypatch):
    """With the port's _STACKED_SLAB_ROWS term (a group's slab priced by
    its rps*128 rows; the reference prices 128 whatever rps) the forced
    per-shard band stores fewer slab bytes than under the reference's
    pricing, which picks the taller groups; the arrays otherwise follow
    the same builders."""
    def band_bytes(rows_term):
        monkeypatch.setattr(tgraph, "_STACKED_SLAB_ROWS", rows_term)
        pg = tpart.partition_graph(edges(), None, N, "gcn", 2,
                                   materialize_bcsr=True,
                                   sparse_layout="band")
        return (pg.band.slabs.numel() + pg.band_t.slabs.numel(),
                pg.band.rps)

    ref_bytes, ref_rps = band_bytes(False)
    port_bytes, port_rps = band_bytes(True)
    assert port_bytes < ref_bytes and port_rps < ref_rps


def jax_shard(stacked, s):
    """One shard's JAX layout from the stacked operands."""
    return stacked.local(tuple(a[s][None] for a in stacked.tree()))


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("layout", ["bcsr", "band", "hybrid"])
def test_per_shard_plain_spmm_matches_pallas(rng, layout, dtype):
    k = 4
    t, j = both(edges(), k, materialize_bcsr=True, sparse_layout=layout,
                dense_dtype=dtype)
    nb, h = t.block, 24
    x = rng.normal(size=(k * nb, h)).astype(np.float32)
    g = rng.normal(size=(k * nb, h)).astype(np.float32)
    w = normalized_edge_weight(edges(), np.ones(edges().shape[1]), N, "gcn")
    dense = np.zeros((k * nb, k * nb))
    np.add.at(dense, (edges()[0], edges()[1]), w)
    fwd, bwd = [], 0.0
    for s in range(k):
        out_s = 0.0
        for name, plain, kernel in (
                ("bcsr", tbcsr.bcsr_spmm_reference, jbcsr.bcsr_spmm),
                ("band", tband.band_spmm_reference, jband.band_spmm)):
            if getattr(t, name) is None:
                continue
            for direction, v in ((name, x), (f"{name}_t",
                                             g[s * nb:(s + 1) * nb])):
                got = plain(getattr(t, direction).local(s, "cpu"),
                            torch.from_numpy(v)).numpy()
                want = np.asarray(kernel(jax_shard(getattr(j, direction), s),
                                         jnp.asarray(v), interpret=True))
                assert got.shape == want.shape, (direction, s)
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                    err_msg=f"{direction} shard {s}")
                if direction == name:
                    out_s = out_s + got
                else:
                    bwd = bwd + got
        fwd.append(out_s)
    # the stacked shards are A @ x, the summed transposes A^T g (int8: the
    # quantization's error, 1/254 of each row's largest weight, x rounded
    # to bf16)
    tol = 1e-5 if dtype == "f32" else 2e-2
    a_x, at_g = dense @ x, dense.T @ g
    np.testing.assert_allclose(np.concatenate(fwd)[:N], a_x[:N], rtol=0,
                               atol=tol * np.abs(a_x).max())
    np.testing.assert_allclose(bwd[:N], at_g[:N], rtol=0,
                               atol=tol * np.abs(at_g).max())


def test_trimmed_band_kernel_rows():
    """A row-range-trimmed layout's product holds its stored groups' rows
    at group g_lo and zeros elsewhere (the kernel's out_row0)."""
    rng = np.random.default_rng(3)
    n, rps = 6 * B, 1
    r = rng.integers(2 * B, 4 * B, 400)
    c = rng.integers(0, 2 * B, 400)
    w = rng.normal(size=400).astype(np.float32)
    full = tband.build_band(r, c, w, n, rps, n_col=2 * B)
    trim = tband.build_band(r, c, w, n, rps, n_col=2 * B, trim_groups=(2, 2),
                            window=(full.w_blocks, full.clo.numpy()))
    assert trim.g_lo == 2 and trim.n_groups == 2 and trim.total_groups == 6
    x = torch.from_numpy(rng.normal(size=(2 * B, 8)).astype(np.float32))
    got = tband.band_spmm_reference(trim, x)
    want = tband.band_spmm_reference(full, x)
    assert torch.equal(got, want)
    assert not got[: 2 * B].any() and not got[4 * B:].any()

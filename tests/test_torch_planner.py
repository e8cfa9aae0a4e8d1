"""The port's layout planner, hybrid split and calibration against
glass_tpu's, on the CPU.

Both planners run under one set of constants: the port's module attributes
are set to ``glass_tpu.ops.graph``'s (the JAX package's TPU fits; the
port's own defaults are the H100's), and some cases also point both at one
``GLASS_TPU_AUTOTUNE`` file.

- The window helpers (``plan_windows``, the histograms, ``best_windows``)
  return arrays equal to the JAX functions'; the planner's sparse windows
  (``_GroupBlocks``, from the block pattern) equal them, ties included.
- ``_plan_block_sparse`` gives the JAX planner's kind, rps and window, and
  its modeled costs within rtol 1e-12 (also from build_graph's row-sorted
  int32 arrays, whose block pattern the native library counts), on the bench pattern
  (``tests/test_planner.py::_bench_pattern``), the outlier chain of
  ``tests/test_pallas_band.py``, a near-dense pattern with every 128x128
  block occupied (as the 14,592-node hpo pattern has), a banded chain, at
  f32, bf16 and int8, for "auto", "band", "hybrid" and "bcsr".
- ``build_graph(sparse_layout="auto" | "hybrid")`` builds the JAX builder's
  layouts (integers equal, values within 1 ulp), the dense and segment
  choices included; ``Graph.plan`` records the choice.
- The hybrid SpMM (band kernel + BCSR kernel, each over its own transposed
  layout in the backward) matches JAX's hybrid and the dense product,
  forward and dx, within rtol 1e-4, for "gcn" and for "mean".
- ``fit_cost_constants`` recovers known constants from synthetic times and
  refuses a non-physical fit; ``ensure_autotune`` writes its file once and
  reuses it.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import glass_tpu.ops.graph as jgraph
import glass_tpu.ops.pallas_band as pb
from glass_tpu.ops.spmm import spmm as jax_spmm
from glass_tpu_torch.ops import autotune as tauto
from glass_tpu_torch.ops import band_spmm as tb
from glass_tpu_torch.ops import bcsr_spmm as tbs
from glass_tpu_torch.ops import dense_q as tdq
from glass_tpu_torch.ops import graph as tgraph
from glass_tpu_torch.ops.band_spmm import BandedAdj
from glass_tpu_torch.ops.spmm import spmm

B = 128
CONSTANTS = ("_BAND_STEP_COST_S", "_BCSR_STEP_COST_S", "_BAND_STREAM_BPS",
             "_MXU_FLOPS", "_GATHER_BPS", "_DENSE_MXU_BYTES_CAP",
             "_LAYOUT_BYTES_CAP")
# the port's own terms, set as the reference's model has them: no fill
# term, the dense candidate's streamed bytes priced, BCSR's stored blocks
# (CHUNK padding included) priced
REFERENCE_TERMS = {"_CARD_ROW_BLOCKS": 0, "_DENSE_BYTE_TERM": True,
                   "_BCSR_LIVE_BLOCKS": False, "_STACKED_SLAB_ROWS": False}
PORT_DEFAULTS = {name: getattr(tgraph, name)
                 for name in CONSTANTS + tuple(REFERENCE_TERMS)}


@pytest.fixture(autouse=True)
def jax_planner_constants(monkeypatch):
    """The port's planner under the JAX planner's constants and model, and
    no calibration file unless a test sets one."""
    for name in CONSTANTS:
        monkeypatch.setattr(tgraph, name, getattr(jgraph, name))
    for name, value in REFERENCE_TERMS.items():
        monkeypatch.setattr(tgraph, name, value)
    monkeypatch.setenv("GLASS_TPU_AUTOTUNE", "")
    monkeypatch.delenv("GLASS_TPU_AUTOTUNE")


@pytest.fixture
def shared_file(monkeypatch, tmp_path):
    """One calibration file for both planners, with constants unlike the
    JAX package's."""
    f = tmp_path / "autotune.json"
    f.write_text(json.dumps({
        "band_step_cost_s": 2.0e-7,
        "bcsr_step_cost_s": 9.0e-7,
        "stream_bps": 9.0e11}))
    monkeypatch.setenv("GLASS_TPU_AUTOTUNE", str(f))
    return f


# ------------------------------------------------------------------ graphs


def chain_edges(rng, n_comm=8, e=4000, csz=B):
    """A symmetric chain of communities (tests/test_pallas_band.py::
    chain_graph)."""
    n = n_comm * csz
    intra = int(0.9 * e)
    ci = rng.integers(0, n_comm, intra)
    cx = rng.integers(0, n_comm - 1, e - intra)
    src = np.r_[ci * csz + rng.integers(0, csz, intra),
                cx * csz + rng.integers(0, csz, e - intra)]
    dst = np.r_[ci * csz + rng.integers(0, csz, intra),
                (cx + 1) * csz + rng.integers(0, csz, e - intra)]
    return np.stack([np.r_[src, dst], np.r_[dst, src]]), n


def outlier_chain_edges(rng, n_comm=8, csz=B, e=4000, n_far=200):
    """The chain plus far edges between the first and last communities
    (tests/test_pallas_band.py:179-186)."""
    ei, n = chain_edges(rng, n_comm, e, csz)
    src = rng.integers(0, csz, size=n_far)
    dst = (n_comm - 1) * csz + rng.integers(0, csz, size=n_far)
    far = np.stack([np.r_[src, dst], np.r_[dst, src]])
    return np.concatenate([ei, far], axis=1), n


def bench_pattern_edges(rng):
    """tests/test_planner.py::_bench_pattern: bench.py::clustered_graph at
    1/8 scale (7,168 nodes, 1.12M directed edges)."""
    rng = np.random.default_rng(0)
    n_comm, csz, e = 56, 128, 560_000
    n = n_comm * csz
    intra = int(0.95 * e)
    ci = rng.integers(0, n_comm, size=intra)
    cx = rng.integers(0, n_comm - 1, size=e - intra)
    src = np.r_[ci * csz + rng.integers(0, csz, size=intra),
                cx * csz + rng.integers(0, csz, size=e - intra)]
    dst = np.r_[ci * csz + rng.integers(0, csz, size=intra),
                (cx + 1) * csz + rng.integers(0, csz, size=e - intra)]
    return np.stack([np.r_[src, dst], np.r_[dst, src]]), n


def near_dense_edges(rng, n=36 * B, e=150_000):
    """An unstructured symmetric graph with every 128x128 block occupied, as
    the 14,592-node hpo pattern of tests/test_planner.py has them, at
    4,608 nodes."""
    r = rng.integers(0, n, e)
    c = rng.integers(0, n, e)
    return np.concatenate([np.stack([r, c]), np.stack([c, r])], axis=1), n


def banded_chain_edges(rng, n=5000):
    """tests/test_planner.py::test_auto_keeps_band_for_banded_graphs: a
    path graph, one narrow diagonal band."""
    ei = np.stack([np.arange(1, n), np.arange(0, n - 1)])
    return np.concatenate([ei, ei[::-1]], axis=1), n


GRAPHS = {"bench_pattern": bench_pattern_edges,
          "outlier_chain": outlier_chain_edges,
          "near_dense": near_dense_edges,
          "banded_chain": banded_chain_edges}


def sorted_coo(ei, n, aggr="gcn"):
    """The (row, col, w) build_graph plans from: sorted by (row, col),
    normalized."""
    w = jgraph.normalized_edge_weight(ei, np.ones(ei.shape[1]), n, aggr)
    row, col = ei[0].astype(np.int64), ei[1].astype(np.int64)
    order = np.lexsort((col, row))
    return row[order], col[order], w[order]


@pytest.fixture(scope="module")
def coo():
    """name -> (row, col, w, n), each graph built once."""
    out = {}
    for name, make in GRAPHS.items():
        ei, n = make(np.random.default_rng(3))
        out[name] = (*sorted_coo(ei, n), n)
    return out


# ----------------------------------------------------------- window helpers


def test_window_helpers_match(rng):
    ei, n = outlier_chain_edges(rng)
    r, c, w = sorted_coo(ei, n)
    w[::11] = 0.0  # zero weights are never in a window
    keep = w != 0
    np.testing.assert_array_equal(tb.block_histogram(r, c, keep, n),
                                  pb.block_histogram(r, c, keep, n))
    for rps in (1, 2, 3, 8):
        counts = pb.block_histogram(r, c, keep, n)
        np.testing.assert_array_equal(
            tb.window_histogram_from_blocks(counts, rps),
            pb.window_histogram_from_blocks(counts, rps))
        cs = pb.window_histogram(r, c, keep, n, rps)
        np.testing.assert_array_equal(tb.window_histogram(r, c, keep, n, rps),
                                      cs)
        for width in (1, 2, 3, 100):
            t_clo, t_cov = tb.best_windows(cs, width)
            j_clo, j_cov = pb.best_windows(cs, width)
            np.testing.assert_array_equal(t_clo, j_clo)
            assert t_clo.dtype == j_clo.dtype and t_cov == j_cov
            t_clo, t_in = tb.plan_windows(r, c, w, n, rps, width)
            j_clo, j_in = pb.plan_windows(r, c, w, n, rps, width)
            np.testing.assert_array_equal(t_clo, j_clo)
            np.testing.assert_array_equal(t_in, j_in)
            assert not t_in[~keep].any()


@pytest.mark.parametrize("rps", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_windows_equal_the_histograms(rps, seed):
    """_GroupBlocks' best windows and residue against best_windows of the
    dense window histogram and plan_windows' mask, on patterns with many
    tied windows (few distinct counts) and empty groups."""
    rng = np.random.default_rng(seed)
    n = 40 * 128 + 17
    e = 3_000
    r = rng.integers(0, n, e)
    r[r // 128 % 5 == 0] = 0  # some empty row blocks, a crowded first one
    c = np.clip(r + rng.choice([-900, -300, 0, 300, 2000], e), 0, n - 1)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    w = np.ones(e, np.float32)
    w[::7] = 0.0
    keep = w != 0
    n_rb = -(-n // 128)
    pattern = tbs.block_pattern(r, c, w, n_rb, n_rb)
    groups = tgraph._GroupBlocks(pattern, rps)
    cs = tb.window_histogram(r, c, keep, n, rps)
    for width in (1, 2, 3, 7, 100):
        clo, covered = groups.best_windows(width)
        d_clo, d_cov = tb.best_windows(cs, width)
        np.testing.assert_array_equal(clo, d_clo)
        assert clo.dtype == d_clo.dtype and covered == d_cov
        _, in_band = tb.plan_windows(r, c, w, n, rps, width)
        out = keep & ~in_band
        bid = np.unique((r[out] // 128) * n_rb + c[out] // 128)
        residue = groups.outside(pattern, width, clo)
        np.testing.assert_array_equal(residue.rb() * n_rb + residue.cb, bid)
        assert residue.n_edges == int(out.sum())


@pytest.mark.parametrize("layout", ["auto", "band", "hybrid", "bcsr"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_of_int32_edges_matches_jax(coo, name, layout):
    """build_graph's host arrays with the native library: int32 rows and
    columns, f32 weights, whose block pattern the library counts."""
    row, col, w, n = coo[name]
    if layout == "hybrid" and name == "near_dense":
        return  # refused by both (test_plan_matches_jax)
    args = (n, "f32", None, layout, True)
    t = tgraph._plan_block_sparse(row.astype(np.int32), col.astype(np.int32),
                                  w.astype(np.float32), *args, with_costs=True)
    j = jgraph._plan_block_sparse(row, col, w, *args, with_costs=True)
    assert_same_plan(t, j)


# ------------------------------------------------------------------ planner


def assert_same_plan(t, j):
    assert t[:3] == j[:3]
    if len(j) == 4:
        assert set(t[3]) == set(j[3])
        for k in j[3]:
            np.testing.assert_allclose(t[3][k], j[3][k], rtol=1e-12, atol=0)


def plan_both(row, col, w, n, dense_dtype, layout, band_rps=None):
    args = (row, col, w, n, dense_dtype, band_rps, layout, True)
    return (tgraph._plan_block_sparse(*args, with_costs=True),
            jgraph._plan_block_sparse(*args, with_costs=True))


@pytest.mark.parametrize("dense_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("layout", ["auto", "band", "hybrid", "bcsr"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_matches_jax(coo, name, layout, dense_dtype):
    row, col, w, n = coo[name]
    if layout == "hybrid" and name == "near_dense":
        # no window carries the bulk: both refuse
        for plan in (tgraph._plan_block_sparse, jgraph._plan_block_sparse):
            with pytest.raises(ValueError, match="hybrid"):
                plan(row, col, w, n, dense_dtype, None, layout, True)
        return
    t, j = plan_both(row, col, w, n, dense_dtype, layout)
    assert_same_plan(t, j)


@pytest.mark.parametrize("name", ["bench_pattern", "outlier_chain",
                                  "banded_chain"])
def test_plan_matches_jax_under_a_shared_file(coo, shared_file, name):
    row, col, w, n = coo[name]
    assert tgraph._cost_constants() == jgraph._cost_constants() != (
        jgraph._BAND_STEP_COST_S, jgraph._BCSR_STEP_COST_S,
        jgraph._BAND_STREAM_BPS)
    for layout in ("auto", "band", "hybrid"):
        t, j = plan_both(row, col, w, n, "f32", layout)
        assert_same_plan(t, j)


def test_plan_takes_band_rps_and_refuses_unpatterned_hybrid(coo):
    row, col, w, n = coo["outlier_chain"]
    for layout in ("auto", "band"):
        t, j = plan_both(row, col, w, n, "f32", layout, band_rps=4)
        assert t[:3] == j[:3] == ("band", 4, None)
    with pytest.raises(ValueError, match="pattern-symmetric"):
        tgraph._plan_block_sparse(row[::2], col[::2], w[::2], n, "f32", None,
                                  "hybrid", False)


def test_forced_band_without_a_window_plans_bcsr(rng):
    """The port's repair (ROADMAP Queue 3): a forced band with no window
    that passes the layout rule is BCSR, where the reference plans rps 8
    past the rule."""
    n = 64 * B
    ei = np.stack([32 * B + rng.integers(0, B, n), np.arange(n)])
    r, c, w = ei[0], ei[1], np.ones(n, np.float32)
    order = np.argsort(r, kind="stable")
    t = tgraph._plan_block_sparse(r[order], c[order], w, n, "f32", None,
                                  "band", False)
    j = jgraph._plan_block_sparse(r[order], c[order], w, n, "f32", None,
                                  "band", False)
    assert t == ("bcsr", None, None) and j == ("band", 8, None)


def test_cost_file_and_caps_read_like_jax(shared_file, monkeypatch):
    assert tgraph._cost_constants() == jgraph._cost_constants() == \
        (2.0e-7, 9.0e-7, 9.0e11)
    bad = shared_file.with_name("bad.json")
    bad.write_text(json.dumps({"stream_bps": 1.0}))
    monkeypatch.setenv("GLASS_TPU_AUTOTUNE", str(bad))
    with pytest.raises(ValueError, match="not a valid autotune file"):
        tgraph._cost_constants()
    monkeypatch.setenv("GLASS_TPU_LAYOUT_BYTES_CAP_GIB", "1.5")
    assert tgraph._layout_bytes_cap() == jgraph._layout_bytes_cap() == \
        int(1.5 * (1 << 30))
    monkeypatch.delenv("GLASS_TPU_LAYOUT_BYTES_CAP_GIB")
    assert tgraph._layout_bytes_cap() == jgraph._layout_bytes_cap()


def test_port_defaults_are_the_cards():
    """None of the port's default constants is a JAX (TPU) value: the times
    and rates are the card's fits, the caps the JAX rule at 80 GiB, and the
    card's two terms are on."""
    for name in CONSTANTS[:5]:
        assert PORT_DEFAULTS[name] != getattr(jgraph, name), name
    assert set(PORT_DEFAULTS["_MXU_FLOPS"]) == set(jgraph._MXU_FLOPS)
    assert PORT_DEFAULTS["_LAYOUT_BYTES_CAP"] == 5 * jgraph._LAYOUT_BYTES_CAP
    assert PORT_DEFAULTS["_DENSE_MXU_BYTES_CAP"] == \
        5 * jgraph._DENSE_MXU_BYTES_CAP
    assert PORT_DEFAULTS["_CARD_ROW_BLOCKS"] > 0
    assert PORT_DEFAULTS["_DENSE_BYTE_TERM"] is False
    assert PORT_DEFAULTS["_BCSR_LIVE_BLOCKS"] is True
    assert PORT_DEFAULTS["_STACKED_SLAB_ROWS"] is True


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_bcsr_cost_counts_live_blocks(monkeypatch, itemsize):
    """With the live-block term on, the BCSR cost of a padded miniature
    streams its nonzero blocks only; off, every stored block as the
    reference does. Row block 0 touches 10 column blocks (2 chunks, 16
    stored), row block 1 three (1 chunk, 8 stored), row block 2 none (its
    placeholder chunk)."""
    n = 10 * B
    row = np.r_[np.zeros(10, np.int64), np.full(3, B)]
    col = np.r_[np.arange(10) * B, np.arange(3) * B]
    monkeypatch.setenv("GLASS_TPU_AUTOTUNE", "")
    monkeypatch.delenv("GLASS_TPU_AUTOTUNE")
    monkeypatch.setattr(tgraph, "_BCSR_STEP_COST_S", 1e-6)
    monkeypatch.setattr(tgraph, "_BAND_STREAM_BPS", 1e12)
    chunks = 2 + 1 + 8  # 8 empty row blocks keep a placeholder chunk each
    for live, blocks in ((True, 13), (False, 24)):
        monkeypatch.setattr(tgraph, "_BCSR_LIVE_BLOCKS", live)
        cost = tgraph._bcsr_cost_model(row, col, n, itemsize)
        want = chunks * 1e-6 + blocks * B * B * itemsize / 1e12
        assert cost == pytest.approx(want, rel=1e-12), live
    t = tbs.build_bcsr(row, col, np.ones(row.size, np.float32), n)
    assert t.live_blocks == 13 and t.nnz_blocks == 24


def two_files(tmp_path, stream_port, stream_jax):
    """Calibration files that differ only in the stream rate."""
    out = []
    for name, stream in (("port", stream_port), ("jax", stream_jax)):
        f = tmp_path / f"{name}.json"
        f.write_text(json.dumps({"band_step_cost_s": 2.0e-7,
                                 "bcsr_step_cost_s": 9.0e-7,
                                 "stream_bps": stream}))
        out.append(str(f))
    return out


@pytest.mark.parametrize("name", ["bench_pattern", "outlier_chain",
                                  "near_dense"])
def test_card_fill_scales_the_stream_rate(coo, tmp_path, monkeypatch, name):
    """With the fill term on, a graph of half the card's row blocks plans
    as the reference plans it at half the stream rate, costs included."""
    row, col, w, n = coo[name]
    port_file, jax_file = two_files(tmp_path, 9.0e11, 4.5e11)
    monkeypatch.setattr(tgraph, "_CARD_ROW_BLOCKS", 2 * -(-n // B))
    for layout in ("auto", "band", "bcsr"):
        args = (row, col, w, n, "f32", None, layout, True)
        monkeypatch.setenv("GLASS_TPU_AUTOTUNE", port_file)
        t = tgraph._plan_block_sparse(*args, with_costs=True)
        monkeypatch.setenv("GLASS_TPU_AUTOTUNE", jax_file)
        j = jgraph._plan_block_sparse(*args, with_costs=True)
        assert_same_plan(t, j)
    # a graph with as many row blocks as the card's: no change
    monkeypatch.setattr(tgraph, "_CARD_ROW_BLOCKS", -(-n // B))
    monkeypatch.setenv("GLASS_TPU_AUTOTUNE", port_file)
    t = tgraph._plan_block_sparse(*args[:6], "auto", True, with_costs=True)
    j = jgraph._plan_block_sparse(*args[:6], "auto", True, with_costs=True)
    assert_same_plan(t, j)


def test_dense_candidate_priced_by_the_matmul_rate(monkeypatch):
    """The port's dense candidate costs its matmul's operations at
    _MXU_FLOPS, and the int8 layout's at the int8 dense kernel's rate
    (_DENSE_Q_FLOPS); with _DENSE_BYTE_TERM the reference's streamed bytes
    come on top of the matmul's."""
    n, n_edge = 4000, 90_000
    assert tdq.dense_q_vmem_ok(n, n)
    for dd, key, itemsize in (("f32", "f32", 4), ("bf16", "bf16", 2),
                              ("int8", "bf16", 1)):
        flops = 2.0 * n * n * 128 / tgraph._MXU_FLOPS[key]
        monkeypatch.setattr(tgraph, "_DENSE_BYTE_TERM", False)
        c = tgraph._dense_segment_costs(n, n_edge, dd)
        own = (2.0 * n * n * 128 / tgraph._DENSE_Q_FLOPS if dd == "int8"
               else flops)
        assert c["dense"] == own and c["dense_bytes"] == n * n * itemsize
        assert c["segment"] == n_edge * 2 * (16 + 128 * 4) / tgraph._GATHER_BPS
        monkeypatch.setattr(tgraph, "_DENSE_BYTE_TERM", True)
        assert tgraph._dense_segment_costs(n, n_edge, dd)["dense"] == \
            n * n * itemsize / tgraph._BAND_STREAM_BPS + flops


@pytest.mark.parametrize("dense_dtype", ["f32", "int8"])
def test_port_defaults_plan_dense_for_a_near_dense_graph(monkeypatch,
                                                         dense_dtype):
    """Under the port's own constants and terms, an unstructured graph
    with every 128x128 block occupied and fewer row blocks than the card
    fills goes to the dense path, as the card's times rank it (PERF.md,
    the hpo stand-in); the card's constants in the reference's model keep
    it block-sparse."""
    ei, n = near_dense_edges(np.random.default_rng(4))
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout="auto", dense_dtype=dense_dtype)
    for name in CONSTANTS:
        monkeypatch.setattr(tgraph, name, PORT_DEFAULTS[name])
    assert tgraph.build_graph(ei, None, n, "gcn", device="cpu",
                              **kw).plan in ("band", "bcsr")
    for name in REFERENCE_TERMS:
        monkeypatch.setattr(tgraph, name, PORT_DEFAULTS[name])
    g = tgraph.build_graph(ei, None, n, "gcn", device="cpu", **kw)
    assert g.plan == "dense" and g.bcsr is None and g.band is None
    assert (g.dense_q is not None) == (dense_dtype == "int8")


# -------------------------------------------------------------- build_graph


def assert_ulp(a, b, ulps=1):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(np.abs(a - b) <= tol), float(np.abs(a - b).max())


def values(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def assert_band_equal(t, j):
    assert (t.rps, t.w_blocks, t.affine_stride, t.affine_off, t.n_node) == \
        (j.rps, j.w_blocks, j.affine_stride, j.affine_off, j.n_node)
    np.testing.assert_array_equal(t.clo.numpy(), np.asarray(j.clo))
    if t.slabs.dtype == torch.int8:
        np.testing.assert_array_equal(t.slabs.numpy(), np.asarray(j.slabs))
        np.testing.assert_array_equal(
            values(t.row_scale),
            np.asarray(j.row_scale, np.float32)[..., 0].reshape(-1))
    else:
        assert_ulp(values(t.slabs), np.asarray(j.slabs, np.float32))


def assert_bcsr_equal(t, j):
    for name in ("block_col", "block_row_ptr", "chunk_start", "chunk_len",
                 "chunk_row", "chunk_first", "chunk_last"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    if t.blocks.dtype == torch.int8:
        np.testing.assert_array_equal(t.blocks.numpy(), np.asarray(j.blocks))
        assert_ulp(t.row_scale.numpy(),
                   np.asarray(j.row_scale, np.float32).reshape(-1))
    else:
        assert_ulp(values(t.blocks), np.asarray(j.blocks, np.float32))


def assert_graph_layouts_equal(tg, jg):
    for name in ("band", "band_t", "bcsr", "bcsr_t", "dense", "dense_q",
                 "dense_q_t"):
        assert (getattr(tg, name) is None) == (getattr(jg, name) is None), name
    for a, b in ((tg.band, jg.band), (tg.band_t, jg.band_t)):
        if a is not None:
            assert_band_equal(a, b)
    for a, b in ((tg.bcsr, jg.bcsr), (tg.bcsr_t, jg.bcsr_t)):
        if a is not None:
            assert_bcsr_equal(a, b)
    if tg.dense is not None:
        assert_ulp(values(tg.dense), np.asarray(jg.dense, np.float32))
    if tg.dense_q is not None:
        np.testing.assert_array_equal(tg.dense_q.q.numpy()[:tg.n_node,
                                                           :tg.n_node],
                                      np.asarray(jg.dense_q.q)[:tg.n_node,
                                                               :tg.n_node])
    assert (tg.band_t is tg.band) == (jg.band_t is jg.band)
    assert (tg.bcsr_t is tg.bcsr) == (jg.bcsr_t is jg.bcsr)


def planned_kind(g) -> str:
    if g.band is not None:
        return "hybrid" if g.bcsr is not None else "band"
    if g.bcsr is not None:
        return "bcsr"
    return "dense" if (g.dense is not None or g.dense_q is not None) \
        else "segment"


BUILDS = [("outlier_chain", "gcn", "auto", "f32"),
          ("outlier_chain", "mean", "auto", "f32"),
          ("outlier_chain", "gcn", "hybrid", "f32"),
          ("outlier_chain", "mean", "hybrid", "bf16"),
          ("outlier_chain", "gcn", "hybrid", "int8"),
          ("bench_pattern", "gcn", "auto", "int8"),
          ("bench_pattern", "gcn", "hybrid", "f32"),
          ("banded_chain", "mean", "auto", "f32"),
          ("near_dense", "gcn", "auto", "bf16")]


@pytest.mark.parametrize("name, aggr, layout, dense_dtype", BUILDS)
def test_build_graph_matches_jax(name, aggr, layout, dense_dtype):
    ei, n = GRAPHS[name](np.random.default_rng(3))
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout=layout, dense_dtype=dense_dtype)
    jg = jgraph.build_graph(ei, None, n, aggr, **kw)
    tg = tgraph.build_graph(ei, None, n, aggr, device="cpu", **kw)
    assert_graph_layouts_equal(tg, jg)
    assert tg.plan == (planned_kind(tg) if layout == "auto" else None)
    if layout == "hybrid":
        assert tg.plan is None and tg.band is not None and tg.bcsr is not None


def test_auto_plans_dense_where_no_band_fits(monkeypatch):
    """A near-dense pattern with no window under the layout rule (as at
    14,592 nodes) goes to the dense path, int8 to the row-quantized
    layout; spmm's "pallas" mode follows the plan."""
    monkeypatch.setattr(tb, "LAYOUT_BUDGET_BYTES", 1 << 20)
    monkeypatch.setattr(pb, "_VMEM_BUDGET", 1 << 20)
    ei, n = near_dense_edges(np.random.default_rng(4))
    x = np.random.default_rng(5).normal(size=(n, 8)).astype(np.float32)
    for dense_dtype in ("f32", "int8"):
        kw = dict(materialize_dense=False, materialize_bcsr=True,
                  sparse_layout="auto", dense_dtype=dense_dtype)
        jg = jgraph.build_graph(ei, None, n, "gcn", **kw)
        tg = tgraph.build_graph(ei, None, n, "gcn", device="cpu", **kw)
        assert tg.plan == "dense"
        assert_graph_layouts_equal(tg, jg)
        out = spmm(tg, torch.from_numpy(x), "pallas")
        ref = np.asarray(jax_spmm(jg, jnp.asarray(x), "pallas"))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())


def test_auto_bytes_cap_falls_back_to_segment(monkeypatch):
    """tests/test_planner.py::test_auto_bytes_cap_falls_back_to_segment on
    both builders: past both memory caps the plan is the segment path."""
    for mod in (tgraph, jgraph):
        monkeypatch.setattr(mod, "_DENSE_MXU_BYTES_CAP", 1 << 20)
        monkeypatch.setattr(mod, "_LAYOUT_BYTES_CAP", 1 << 20)
    ei, n = near_dense_edges(np.random.default_rng(6))
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout="auto")
    jg = jgraph.build_graph(ei, None, n, "gcn", **kw)
    tg = tgraph.build_graph(ei, None, n, "gcn", device="cpu", **kw)
    assert tg.plan == "segment"
    assert_graph_layouts_equal(tg, jg)
    assert jg.dense is None and jg.bcsr is None and jg.band is None
    x = torch.randn(n, 5)
    torch.testing.assert_close(spmm(tg, x, "pallas"), spmm(tg, x, "segment"),
                               rtol=0, atol=0)
    monkeypatch.setenv("GLASS_TPU_LAYOUT_BYTES_CAP_GIB", "1")
    assert tgraph.build_graph(ei, None, n, "gcn", device="cpu",
                              **kw).plan != "segment"


# ---------------------------------------------------------- the hybrid SpMM


@pytest.mark.parametrize("aggr", ["gcn", "mean"])
def test_hybrid_spmm_matches_jax_and_dense(aggr):
    ei, n = outlier_chain_edges(np.random.default_rng(7))
    kw = dict(materialize_dense=True, materialize_bcsr=True,
              sparse_layout="hybrid")
    jg = jgraph.build_graph(ei, None, n, aggr, **kw)
    tg = tgraph.build_graph(ei, None, n, aggr, device="cpu", **kw)
    assert isinstance(tg.band, BandedAdj) and tg.bcsr is not None
    assert (tg.band_t is tg.band) == (aggr == "gcn")
    rng = np.random.default_rng(8)
    x = rng.normal(size=(n, 17)).astype(np.float32)
    w = rng.normal(size=(n, 17)).astype(np.float32)

    def jax_loss(mode):
        return lambda v: (jax_spmm(jg, v, mode) * w).sum()

    j_out = np.asarray(jax_spmm(jg, jnp.asarray(x), "pallas"))
    j_dx = np.asarray(jax.grad(jax_loss("pallas"))(jnp.asarray(x)))
    for mode in ("pallas", "hybrid"):
        xt = torch.from_numpy(x).requires_grad_()
        out = spmm(tg, xt, mode)
        (out * torch.from_numpy(w)).sum().backward()
        for ours, ref in ((out.detach().numpy(), j_out),
                          (xt.grad.numpy(), j_dx)):
            np.testing.assert_allclose(ours, ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref).max())
    xt = torch.from_numpy(x).requires_grad_()
    (spmm(tg, xt, "dense") * torch.from_numpy(w)).sum().backward()
    xh = torch.from_numpy(x).requires_grad_()
    out = spmm(tg, xh, "hybrid")
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               spmm(tg, torch.from_numpy(x), "dense").numpy(),
                               rtol=1e-4, atol=1e-4 * np.abs(j_out).max())
    np.testing.assert_allclose(xh.grad.numpy(), xt.grad.numpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(j_dx).max())


# -------------------------------------------------------------- calibration


def synthetic_measure(band_step, bcsr_step, stream_bps):
    """measure() whose times are the model's own at known constants."""
    def measure(fn, x, iters, layout):
        if isinstance(layout, BandedAdj):
            nbytes = layout.slabs.numel() * layout.slabs.element_size()
            return layout.n_groups * band_step + nbytes / stream_bps
        # the BCSR kernel streams the live blocks, not the CHUNK padding
        nbytes = layout.live_blocks * B * B * layout.blocks.element_size()
        return int(layout.chunk_start.shape[0]) * bcsr_step + \
            nbytes / stream_bps
    return measure


def test_fit_recovers_known_constants():
    fit = tauto.fit_cost_constants(
        device="cpu", measure=synthetic_measure(2.5e-6, 7.0e-6, 8.0e11),
        log=lambda s: None)
    np.testing.assert_allclose(
        [fit["band_step_cost_s"], fit["bcsr_step_cost_s"], fit["stream_bps"]],
        [2.5e-6, 7.0e-6, 8.0e11], rtol=1e-6)
    assert fit["backend"] == "cpu"


@pytest.mark.parametrize("band_step, stream", [(-1e-6, 8e11), (1e-6, -8e11)])
def test_fit_refuses_a_non_physical_fit(band_step, stream):
    with pytest.raises(tauto.FitRefused, match="non-physical"):
        tauto.fit_cost_constants(
            device="cpu", measure=synthetic_measure(band_step, 1e-6, stream),
            log=lambda s: None)


@pytest.mark.parametrize("band_step, bcsr_step, stream, ok", [
    (3.5e-9, 1.0e-8, 9.7e11, True),    # an H100 fit: 0.46 and 1.3 us per SM
    (1.0e-6, 7.0e-6, 8.0e11, True),    # a TPU-like fit on one SM
    (3.5e-11, 1.0e-8, 9.7e11, False),  # 4.6 ns per SM: under 10 ns
    (3.5e-9, 1.0e-5, 9.7e11, False),   # 1.3 ms per SM: over 1 ms
    (3.5e-9, 1.0e-8, 2.0e13, False),   # faster than 10 TB/s
    (3.5e-9, 1.0e-8, 5.0e8, False),    # slower than 1 GB/s
])
def test_plausible_range_is_the_jax_range_per_sm(band_step, bcsr_step,
                                                 stream, ok):
    sms = 1 if band_step == 1.0e-6 else 132
    if ok:
        tauto.check_plausible(band_step, bcsr_step, stream, sms)
    else:
        with pytest.raises(tauto.FitRefused, match="plausible range"):
            tauto.check_plausible(band_step, bcsr_step, stream, sms)
    assert tauto.STEP_RANGE_S == (1e-8, 1e-3)
    assert tauto.STREAM_RANGE_BPS == (1e9, 1e13)


def test_fit_times_the_plain_versions_on_the_cpu():
    fit = tauto.fit_cost_constants(iters=1, device="cpu", log=lambda s: None)
    assert set(fit) >= {"band_step_cost_s", "bcsr_step_cost_s", "stream_bps"}
    assert fit["bcsr_step_cost_s"] >= tauto.STEP_RANGE_S[0]


def test_ensure_autotune_writes_once_and_reuses(tmp_path, monkeypatch):
    path = tmp_path / "cal" / "autotune.json"
    calls = []

    def measure(fn, x, iters, layout):
        calls.append(1)
        return synthetic_measure(1e-6, 3e-6, 5e11)(fn, x, iters, layout)

    assert tauto.ensure_autotune(str(path), device="cpu",
                                 measure=measure) == str(path)
    assert len(calls) == 6
    saved = json.loads(path.read_text())
    import os

    assert os.environ["GLASS_TPU_AUTOTUNE"] == str(path)
    assert tgraph._cost_constants() == jgraph._cost_constants() == (
        saved["band_step_cost_s"], saved["bcsr_step_cost_s"],
        saved["stream_bps"])
    tauto.ensure_autotune(str(path), device="cpu", measure=measure)
    assert len(calls) == 6  # reused, not refitted
    tauto.ensure_autotune(str(path), device="cpu", measure=measure,
                          refit=True)
    assert len(calls) == 12
    refused = tmp_path / "refused.json"
    with pytest.raises(tauto.FitRefused):
        tauto.ensure_autotune(str(refused), device="cpu",
                              measure=synthetic_measure(-1e-6, 1e-6, 5e11))
    assert not refused.exists()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    card = tauto.default_autotune_path("cuda")
    assert card.parent == tmp_path / "xdg" / "glass_tpu_torch"
    assert card.name.startswith("autotune_cuda-") and card.suffix == ".json"
    assert tauto.default_autotune_path("cpu") == \
        tmp_path / "xdg" / "glass_tpu_torch" / "autotune_cpu.json"

"""Parity of the port's graph and BCSR layout builders with glass_tpu's.

The same numpy inputs go through ``glass_tpu.ops.graph.build_graph`` /
``glass_tpu.ops.pallas_spmm.build_bcsr_arrays`` and their counterparts in
``glass_tpu_torch``. Integer arrays must be equal; float arrays may differ by
1 ulp (the JAX builders may use the native host library, which accumulates
duplicate edges in another order).
"""

import numpy as np
import pytest
import torch

from glass_tpu.ops import graph as jgraph
from glass_tpu.ops import pallas_spmm as jspmm
from glass_tpu_torch.ops import bcsr_spmm as tbcsr
from glass_tpu_torch.ops import graph as tgraph
# both planners under the JAX planner's constants (autouse)
from test_torch_planner import (assert_graph_layouts_equal,  # noqa: F401
                                jax_planner_constants, planned_kind)


def assert_ulp(a, b, ulps=1):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(np.abs(a - b) <= tol), float(np.abs(a - b).max())


def case_edges(name, rng):
    """(edge_index, edge_weight, n_node) of the named case."""
    if name == "random":
        n = 300
        src, dst = rng.integers(0, n, 900), rng.integers(0, n, 900)
        return np.stack([np.r_[src, dst], np.r_[dst, src]]), None, n
    if name == "empty_row_blocks":
        # edges only among the first and last of five row blocks
        n = 5 * 128
        a = rng.integers(0, 128, (2, 300))
        b = rng.integers(4 * 128, n, (2, 300))
        ei = np.concatenate([a, b, a[::-1], b[::-1]], axis=1)
        return ei, None, n
    if name == "ragged_n":
        n = 3 * 128 + 45  # n % 128 != 0
        src, dst = rng.integers(0, n, 700), rng.integers(0, n, 700)
        return np.stack([src, dst]), rng.uniform(0.1, 2, 700), n
    if name == "duplicates_and_zeros":
        n = 260
        src, dst = rng.integers(0, n, 400), rng.integers(0, n, 400)
        ei = np.stack([np.r_[src, src[:80]], np.r_[dst, dst[:80]]])
        w = rng.uniform(0.1, 2, ei.shape[1])
        w[::7] = 0.0
        return ei, w, n
    if name == "wide_row":
        # row block 0 touches 11 column blocks: more than one chunk
        n = 12 * 128
        src = rng.integers(0, 128, 600)
        dst = rng.integers(0, n, 600)
        return np.stack([src, dst]), None, n
    if name == "no_edges":
        return np.zeros((2, 0), np.int64), None, 200
    raise KeyError(name)


CASES = ["random", "empty_row_blocks", "ragged_n", "duplicates_and_zeros",
         "wide_row", "no_edges"]


@pytest.mark.parametrize("aggr", ["mean", "sum", "gcn"])
@pytest.mark.parametrize("case", CASES[:4])
def test_normalized_edge_weight_matches(rng, case, aggr):
    ei, w, n = case_edges(case, rng)
    w = np.ones(ei.shape[1], np.float32) if w is None else w
    ref = jgraph.normalized_edge_weight(ei, w, n, aggr)
    out = tgraph.normalized_edge_weight(ei, w, n, aggr)
    np.testing.assert_array_equal(out, ref)


def test_degrees_match(rng):
    ei, w, n = case_edges("duplicates_and_zeros", rng)
    np.testing.assert_array_equal(tgraph.degrees(ei, w, n),
                                  jgraph.degrees(ei, w, n))


def canonical(row, col, w):
    """Edge arrays in a canonical order: duplicate (row, col) pairs may sit
    in either order (COO semantics do not depend on it)."""
    order = np.lexsort((w, col, row))
    return row[order], col[order], w[order]


@pytest.mark.parametrize("case", CASES)
def test_build_graph_matches(rng, case):
    ei, w, n = case_edges(case, rng)
    aggr = "sum" if case == "no_edges" else "gcn"
    jg = jgraph.build_graph(ei, w, n, aggr, materialize_dense=True)
    tg = tgraph.build_graph(ei, w, n, aggr, materialize_dense=True,
                            device="cpu")
    assert (tg.n_node, tg.n_edge, tg.aggr) == (jg.n_node, jg.n_edge, jg.aggr)
    assert tg.row.dtype == torch.int64 and tg.weight.dtype == torch.float32
    jr, jc, jw = canonical(np.asarray(jg.row, np.int64),
                           np.asarray(jg.col, np.int64), np.asarray(jg.weight))
    tr, tc, tw = canonical(tg.row.numpy(), tg.col.numpy(), tg.weight.numpy())
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tc, jc)
    assert_ulp(tw, jw)
    assert_ulp(tg.dense.numpy(), np.asarray(jg.dense))
    # the port's own order is the (row, col) sort of the JAX numpy path
    key = tg.row.numpy()[: tg.n_edge] * n + tg.col.numpy()[: tg.n_edge]
    assert np.all(np.diff(key) >= 0)


@pytest.mark.parametrize("case", CASES)
def test_build_bcsr_arrays_match(rng, case):
    ei, w, n = case_edges(case, rng)
    w = np.ones(ei.shape[1], np.float32) if w is None else w
    # the port's normalization (held against the JAX one above, which
    # fails on a graph without edges)
    wn = tgraph.normalized_edge_weight(ei, w, n, "mean")
    ref = jspmm.build_bcsr_arrays(ei[0], ei[1], wn, n)
    out = tbcsr.build_bcsr_arrays(ei[0], ei[1], wn, n)
    for key in ("block_col", "block_row_ptr", "chunk_start", "chunk_len",
                "chunk_row", "chunk_first", "chunk_last"):
        assert out[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    assert (out["n_rb"], out["n_cb"]) == (ref["n_rb"], ref["n_cb"])
    assert out["blocks"].shape == ref["blocks"].shape
    assert out["blocks"].dtype == torch.float32
    assert_ulp(out["blocks"], ref["blocks"])


def test_layout_cases_are_present(rng):
    """The cases above reach what they are named for."""
    ptr = tbcsr.build_bcsr_arrays(*case_edges("empty_row_blocks", rng)[0],
                                  np.ones(1200, np.float32), 640)["block_row_ptr"]
    assert list(np.diff(ptr)[1:4]) == [0, 0, 0]
    ei, _, n = case_edges("wide_row", rng)
    a = tbcsr.build_bcsr_arrays(ei[0], ei[1], np.ones(ei.shape[1]), n)
    assert np.diff(a["block_row_ptr"])[0] == 2 * tbcsr.CHUNK
    empty = tbcsr.build_bcsr_arrays(np.zeros(0, int), np.zeros(0, int),
                                    np.zeros(0), 200)
    assert empty["blocks"].shape == (1, 128, tbcsr.CHUNK * 128)
    assert not empty["blocks"].any()


def test_build_graph_bcsr_layout_and_symmetry(rng):
    ei, _, n = case_edges("random", rng)
    jg = jgraph.build_graph(ei, None, n, "mean", materialize_bcsr=True,
                            sparse_layout="bcsr")
    tg = tgraph.build_graph(ei, None, n, "mean", materialize_bcsr=True,
                            sparse_layout="bcsr", device="cpu")
    # 'mean' is not symmetric: a transposed layout of its own
    assert tg.bcsr_t is not tg.bcsr and jg.bcsr_t is not jg.bcsr
    for t, j in ((tg.bcsr, jg.bcsr), (tg.bcsr_t, jg.bcsr_t)):
        np.testing.assert_array_equal(t.block_col.numpy(),
                                      np.asarray(j.block_col))
        assert_ulp(t.blocks.numpy(), np.asarray(j.blocks))
    sym = tgraph.build_graph(ei, None, n, "gcn", materialize_bcsr=True,
                             sparse_layout="bcsr", device="cpu")
    assert sym.bcsr_t is sym.bcsr


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_coo_is_symmetric_matches(rng, aggr):
    ei, _, n = case_edges("random", rng)
    w = jgraph.normalized_edge_weight(ei, np.ones(ei.shape[1]), n, aggr)
    assert tbcsr.coo_is_symmetric(ei[0], ei[1], w) == \
        jspmm.coo_is_symmetric(ei[0], ei[1], w)
    assert tbcsr.coo_is_symmetric(ei[0], ei[1], w) == (aggr == "sum")


@pytest.mark.parametrize("kwargs, item", [
    (dict(materialize_bcsr=True), "item 6"),
    (dict(materialize_bcsr=True, sparse_layout="auto"), "item 6"),
    (dict(materialize_bcsr=True, sparse_layout="hybrid"), "item 6"),
])
def test_unported_layouts_raise(rng, kwargs, item):
    """The layouts that once raised naming ROADMAP Queue 1 ``item`` (the
    planner's "auto", the default, and the hybrid split) build what the JAX
    builder builds, or refuse what it refuses."""
    ei, _, n = case_edges("random", rng)
    try:
        jg = jgraph.build_graph(ei, None, n, "gcn", **kwargs)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:40]):
            tgraph.build_graph(ei, None, n, "gcn", device="cpu", **kwargs)
        return
    tg = tgraph.build_graph(ei, None, n, "gcn", device="cpu", **kwargs)
    assert_graph_layouts_equal(tg, jg)
    assert tg.plan == (None if kwargs.get("sparse_layout") == "hybrid"
                       else planned_kind(tg))


@pytest.mark.parametrize("kwargs, dtypes", [
    (dict(materialize_bcsr=True, sparse_layout="band", dense_dtype="bf16"),
     dict(band=torch.bfloat16)),
    (dict(dense_dtype="bf16"), dict(dense=torch.bfloat16)),
    (dict(dense_dtype="int8"), dict(dense_q=torch.int8)),
    (dict(materialize_bcsr=True, sparse_layout="band", dense_dtype="int8"),
     dict(band=torch.int8)),
])
def test_dtype_layouts_build(rng, kwargs, dtypes):
    """The bf16 and int8 adjacencies (once refused, ROADMAP item 7) build
    at the JAX builder's dtypes; tests/test_torch_quant.py holds their
    arrays against it."""
    ei, _, n = case_edges("random", rng)
    g = tgraph.build_graph(ei, None, n, "gcn", device="cpu", **kwargs)
    for name, dtype in dtypes.items():
        layout = getattr(g, name)
        held = layout if name == "dense" else (
            layout.q if name == "dense_q" else layout.slabs)
        assert held.dtype == dtype, name
    with pytest.raises(ValueError, match="dense_dtype"):
        tgraph.build_graph(ei, None, n, "gcn", device="cpu",
                           dense_dtype="fp16")


def test_out_of_range_edges_raise():
    with pytest.raises(ValueError, match="lie in"):
        tbcsr.build_bcsr_arrays(np.array([0, 5]), np.array([1, 2]),
                                np.ones(2), 5)

"""The port's native host library (``glass_tpu_torch/native.py``, built by
g++ from the port's own ``glass_tpu_torch/csrc/glass_host.cpp``) against the JAX package's binding of
the tracked ``native/libglass_host.so``, on the CPU.

Held byte for byte (``assert_array_equal`` on every output, dtypes
included): ``build_csr``, ``rcm_ordering``, ``band_fill``, ``bcsr_fill``
and ``negative_sample`` on random undirected graphs of 300, 5,000 and
20,000 nodes
(random, banded and with isolated nodes), and the block-sparse builders
that call the fills; the lean build's pieces (the counting-sort CSR, also
against the numpy branch, on adversarial edge lists: duplicate edges of
different weights, reversed and shuffled input, self-loops and isolated
nodes, one hub row, no edges; the column order, the block pattern, the
BCSR fill in row order, the batched int8 quantization, and the symmetry
test against the rule it replaces); the port's native builds against its own numpy
branches; the protocol's RCM route (relabel, then the planned layouts)
against ``glass_tpu.train.protocol``'s; and the RCM order of chip_smoke.py's
57,344-node stand-in, whose digest chip_smoke.py holds the card's build to.
A compiler that refuses -fopenmp gets the serial build, with the same
outputs; without a compiler the port warns once and takes the numpy and
scipy branches.
"""

import numpy as np
import pytest

from glass_tpu import native as jnative
from glass_tpu.ops import pallas_band as jband
from glass_tpu.ops import pallas_spmm as jspmm
from glass_tpu.train import protocol as jprotocol
from glass_tpu_torch import native as tnative
from glass_tpu_torch.ops import band_spmm as tband
from glass_tpu_torch.ops import bcsr_spmm as tbcsr
from glass_tpu_torch.ops import graph as tgraph
from glass_tpu_torch.ops._common import BLOCK
from glass_tpu_torch.train import protocol as tprotocol

from test_torch_planner import (assert_graph_layouts_equal,  # noqa: F401
                                jax_planner_constants)
from test_torch_protocol import write_subgnn

SIZES = (300, 5_000, 20_000)
KINDS = ("random", "banded", "isolated")


def graph(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """An undirected (2, E) edge list of ``n`` nodes, both directions."""
    rng = np.random.default_rng(seed)
    e = 6 * n
    if kind == "random":
        ei = rng.integers(0, n, (2, e))
    elif kind == "banded":
        r = rng.integers(0, n, e)
        ei = np.stack([r, np.clip(r + rng.integers(-40, 41, e), 0, n - 1)])
    else:  # every third node only: the rest isolated
        ei = rng.integers(0, n // 3, (2, e)) * 3
    return np.concatenate([ei, ei[::-1]], axis=1)


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    assert tnative.is_available(), "the port's native library did not build"
    assert jnative.is_available(), "the JAX package's library did not load"


def test_library_is_built_from_source():
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert path.name.startswith("libglass_host-") and path.suffix == ".so"
    assert path.with_suffix(".log").exists()
    assert "-march=native" not in tnative.CXX_FLAGS
    assert tnative._load()._name == str(path)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_rcm_matches_jax_native(kind, n):
    ei = graph(kind, n)
    perm = tnative.rcm_ordering(ei, n)
    np.testing.assert_array_equal(perm, jnative.rcm_ordering(ei, n))
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(np.sort(perm), np.arange(n))


def test_standin_rcm_order_digest():
    """chip_smoke.py's em_user stand-in (57,344 nodes, 9M edges) and its
    RCM order by the JAX package's library, by the digests chip_smoke.py
    holds the card's build to; the port's order here is that order."""
    import chip_smoke as cs

    ei, n = cs.clustered_graph()
    assert cs.sha256(ei) == cs.STANDIN_EDGES_SHA256
    perm = jnative.rcm_ordering(ei, n)
    assert cs.sha256(perm) == cs.STANDIN_RCM_SHA256
    np.testing.assert_array_equal(tnative.rcm_ordering(ei, n), perm)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("aggr", ["gcn", "mean", "sum"])
@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weights"])
def test_build_csr_matches_jax_native(n, aggr, weighted):
    ei = graph("random", n)
    w = (np.random.default_rng(1).uniform(0.5, 2.0, ei.shape[1])
         .astype(np.float32) if weighted else None)
    for a, b in zip(tnative.build_csr(ei, w, n, aggr),
                    jnative.build_csr(ei, w, n, aggr)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def sorted_coo(ei, n):
    """The (row, col, weight) arrays build_graph hands the layout builders."""
    row, col, w = tnative.build_csr(ei, None, n, "gcn")
    return row.astype(np.int64), col.astype(np.int64), w


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["banded", "isolated"])
def test_band_fill_matches_jax_native(kind, n):
    row, col, w = sorted_coo(graph(kind, n), n)
    rps = 2
    wb, clo, _, _ = tband.band_stats(row, col, np.ones_like(row), n, rps)
    n_g = clo.shape[0]
    a = tnative.band_fill(row, col, w, rps, wb, clo, n_g)
    np.testing.assert_array_equal(
        a, jnative.band_fill(row, col, w, rps, wb, clo, n_g))
    assert a.dtype == np.float32 and np.abs(a).sum() > 0
    t = tband.build_band_arrays(row, col, w, n, rps)
    j = jband.build_band_arrays(row, col, w, n, rps)
    np.testing.assert_array_equal(t["slabs"].numpy(), j["slabs"])
    np.testing.assert_array_equal(t["clo"], j["clo"])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_bcsr_fill_matches_jax_native(kind, n):
    row, col, w = sorted_coo(graph(kind, n), n)
    t = tbcsr.build_bcsr_arrays(row, col, w, n)
    j = jspmm.build_bcsr_arrays(row, col, w, n)
    np.testing.assert_array_equal(t["blocks"].numpy(), j["blocks"])
    for name in ("block_col", "block_row_ptr"):
        np.testing.assert_array_equal(t[name], j[name])
    # the fill itself, on the slots the builder computed
    rng = np.random.default_rng(2)
    e_dst = np.sort(rng.integers(0, 4 * tbcsr.CHUNK, row.shape[0]))
    np.testing.assert_array_equal(
        tnative.bcsr_fill(row, col, w, e_dst, tbcsr.CHUNK, 4),
        jnative.bcsr_fill(row, col, w, e_dst, tbcsr.CHUNK, 4))


ADVERSARIAL = ("duplicates", "reversed", "shuffled", "loops_isolated",
               "hub", "empty")


def adversarial(case: str, n: int = 2_000, seed: int = 3):
    """(edge_index (2, E) int64, weights (E,) f32) of an adversarial edge
    list (ADVERSARIAL): duplicate edges of different weights, the sorted
    list reversed, shuffled, self-loops with two thirds of the nodes
    isolated, one row holding most edges, no edges."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, 8 * n))
    if case == "duplicates":  # every edge 1-4 times, the copies scattered
        ei = np.repeat(ei[:, : 2 * n], rng.integers(1, 5, 2 * n), axis=1)
        ei = ei[:, rng.permutation(ei.shape[1])]
    elif case == "reversed":
        ei = ei[:, np.lexsort((ei[1], ei[0]))[::-1]]
    elif case == "shuffled":
        ei = np.concatenate([ei, ei[::-1]], axis=1)
        ei = ei[:, rng.permutation(ei.shape[1])]
    elif case == "loops_isolated":
        ids = rng.integers(0, n // 3, 4 * n) * 3
        ei = np.stack([ids, np.where(rng.random(4 * n) < 0.3, ids,
                                     rng.integers(0, n // 3, 4 * n) * 3)])
    elif case == "hub":
        hub = rng.random(ei.shape[1]) < 0.8
        ei[0, hub] = n // 2
    elif case == "empty":
        ei = np.zeros((2, 0), dtype=np.int64)
    w = rng.uniform(0.25, 2.0, ei.shape[1]).astype(np.float32)
    w[rng.random(w.shape[0]) < 0.05] = 0.0
    return ei.astype(np.int64), w


def numpy_csr(ei, w, n, aggr):
    """build_graph's numpy branch: normalize, then lexsort by (row, col)."""
    w = np.ones(ei.shape[1], np.float32) if w is None else w
    nw = tgraph.normalized_edge_weight(ei, w, n, aggr)
    order = np.lexsort((ei[1], ei[0]))
    return ei[0][order], ei[1][order], nw[order]


@pytest.mark.parametrize("case", ADVERSARIAL)
@pytest.mark.parametrize("aggr", ["gcn", "mean", "sum"])
@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weights"])
def test_build_csr_on_adversarial_edges(case, aggr, weighted):
    """The counting-sort CSR against the JAX package's library and the numpy
    branch, byte for byte, and padded in place to a bucket."""
    n = 2_000
    ei, w = adversarial(case, n)
    w = w if weighted else None
    got = tnative.build_csr(ei, w, n, aggr)
    for a, b in zip(got, jnative.build_csr(ei, w, n, aggr)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    row, col, nw = numpy_csr(ei, w, n, aggr)
    np.testing.assert_array_equal(got[0], row)
    np.testing.assert_array_equal(got[1], col)
    np.testing.assert_array_equal(got[2], nw)
    e = ei.shape[1]
    padded = tnative.build_csr(ei, w, n, aggr, pad_to=e + 1000)
    for a, b in zip(padded, got):
        np.testing.assert_array_equal(a[:e], b)
    assert (padded[0][e:] == n - 1).all() and (padded[1][e:] == n - 1).all()
    assert (padded[2][e:] == 0).all()


def test_build_csr_refuses_rows_outside_the_graph():
    ei = np.array([[0, 5], [1, 1]])
    with pytest.raises(RuntimeError, match="glass_build_csr"):
        tnative.build_csr(ei, None, 5, "sum")


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_col_order_is_numpys_stable_argsort(case):
    ei, _ = adversarial(case)
    col = ei[1].astype(np.int32)
    got = tnative.col_order(col, 2_000)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.argsort(col, kind="stable"))
    assert tnative.col_order(ei[1], 2_000) is None  # int64: not the lean path


def reference_is_symmetric(row, col, w) -> bool:
    """The symmetry rule coo_is_symmetric held before its lean path."""
    keep = w != 0
    row, col, w = row[keep], col[keep], w[keep]
    n = int(max(row.max(), col.max())) + 1 if row.size else 1
    k1 = row.astype(np.int64) * n + col
    k2 = col.astype(np.int64) * n + row
    o1 = np.argsort(k1, kind="stable")
    o2 = np.argsort(k2, kind="stable")
    return np.array_equal(k1[o1], k2[o2]) and np.allclose(w[o1], w[o2])


SYMMETRY_CASES = ("gcn", "sum_duplicates", "mean", "missing_mirror",
                  "zero_mirror", "near_equal", "unsorted", "empty")


def symmetry_case(case: str, n: int = 1_500):
    """(row, col, w) of an undirected graph, normalized and sorted as
    build_graph gives them, then made (a)symmetric as ``case`` says."""
    rng = np.random.default_rng(5)
    ei = rng.integers(0, n, (2, 6 * n))
    if case == "sum_duplicates":
        ei = np.repeat(ei, 2, axis=1)
    ei = np.concatenate([ei, ei[::-1]], axis=1)
    if case == "empty":
        ei = ei[:, :0]
    aggr = {"mean": "mean", "sum_duplicates": "sum"}.get(case, "gcn")
    row, col, w = tnative.build_csr(ei, None, n, aggr)
    w = w.copy()
    off = np.flatnonzero(row != col)
    if case == "missing_mirror":  # one edge's mirror dropped
        keep = np.ones(row.shape[0], bool)
        keep[off[7]] = False
        row, col, w = row[keep], col[keep], w[keep]
    elif case == "zero_mirror":  # one edge's weight zero, its mirror not
        w[off[11]] = 0.0
    elif case == "near_equal":  # within allclose of the mirror
        w[off[3]] *= np.float32(1 + 1e-6)
    elif case == "unsorted":
        p = rng.permutation(row.shape[0])
        row, col, w = row[p], col[p], w[p]
    return row, col, w


@pytest.mark.parametrize("case", SYMMETRY_CASES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_symmetry_test_keeps_its_rule(case, dtype):
    row, col, w = symmetry_case(case)
    row, col = row.astype(dtype), col.astype(dtype)
    want = reference_is_symmetric(row, col, w)
    assert tbcsr.coo_is_symmetric(row, col, w) is want
    pattern_w = (w != 0).astype(np.float32)
    assert tbcsr.coo_is_symmetric(row, col, pattern_w) is \
        reference_is_symmetric(row, col, pattern_w)
    expected = {"gcn": True, "sum_duplicates": True, "mean": False,
                "missing_mirror": False, "zero_mirror": False,
                "near_equal": True, "unsorted": True, "empty": True}
    assert want is expected[case]


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_symmetry_test_pairs_duplicates_in_input_order(swap, shuffle):
    """Duplicate edges of different weights: the rule pairs the k-th copy
    of (a, b) with the k-th copy of (b, a), in input order."""
    row = np.array([0, 0, 1, 1, 2, 2, 3])
    col = np.array([1, 1, 0, 0, 3, 2, 2])
    w = np.array([1, 2, 1, 2, 5, 7, 5], np.float32)
    if swap:
        w[2:4] = w[3], w[2]
    if shuffle:
        p = np.random.default_rng(0).permutation(row.shape[0])
        row, col, w = row[p], col[p], w[p]
    want = reference_is_symmetric(row, col, w)
    if not shuffle:
        assert want is not swap
    assert tbcsr.coo_is_symmetric(row, col, w) is want
    assert tbcsr.coo_is_symmetric(row.astype(np.int32),
                                  col.astype(np.int32), w) is want


def test_symmetry_test_in_batches(monkeypatch):
    """The lean comparison batch by batch: a mismatch in a later batch."""
    row, col, w = symmetry_case("gcn")
    monkeypatch.setattr(tbcsr, "SYM_BATCH", 1_000)
    assert tbcsr.coo_is_symmetric(row, col, w)
    w = w.copy()
    w[np.flatnonzero(row != col)[-5]] *= 2
    assert not tbcsr.coo_is_symmetric(row, col, w)


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_block_pattern_native_equals_numpy(case):
    n = 2_000
    ei, w = adversarial(case, n)
    row, col, nw = tnative.build_csr(ei, w, n, "sum")
    n_rb = -(-n // BLOCK)
    fast = tbcsr.block_pattern(row, col, nw, n_rb, n_rb)
    slow = tbcsr.block_pattern(row.astype(np.int64), col.astype(np.int64),
                               nw, n_rb, n_rb)
    for name in ("ptr", "cb", "cnt"):
        a, b = getattr(fast, name), getattr(slow, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    assert fast.n_edges == int((nw != 0).sum())


@pytest.mark.parametrize("case", ADVERSARIAL)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_lean_bcsr_build_matches_jax(case, dtype, monkeypatch):
    """The BCSR build of build_graph's row-sorted int32 arrays (the block
    pattern, the fill in row order, int8 quantized a few chunks at a
    time) against the JAX builder on the same edges widened to int64."""
    n = 2_000
    ei, w = adversarial(case, n)
    row, col, nw = tnative.build_csr(ei, w, n, "sum")
    monkeypatch.setattr(tbcsr, "QUANT_BATCH", 3)
    assert tnative.block_counts(row, col, nw, -(-n // BLOCK),
                                -(-n // BLOCK)) is not None
    t = tbcsr.build_bcsr_arrays(row, col, nw, n, dtype)
    j = jspmm.build_bcsr_arrays(row.astype(np.int64), col.astype(np.int64),
                                nw, n, dtype)
    np.testing.assert_array_equal(t["blocks"].numpy(), np.asarray(j["blocks"]))
    for name in ("block_col", "block_row_ptr", "chunk_start", "chunk_len",
                 "chunk_row", "chunk_first", "chunk_last"):
        np.testing.assert_array_equal(t[name], np.asarray(j[name]))
    if dtype == "int8":
        np.testing.assert_array_equal(t["row_scale"],
                                      np.asarray(j["row_scale"]))
    # the port's own table, against the int64 (sorting) path
    s = tbcsr.build_bcsr_arrays(row.astype(np.int64), col.astype(np.int64),
                                nw, n, dtype)
    np.testing.assert_array_equal(t["block_row_end"], s["block_row_end"])
    np.testing.assert_array_equal(t["blocks"].numpy(), s["blocks"].numpy())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_negative_sample_matches_jax_native(kind, n):
    ei = graph(kind, n)
    for seed in (0, 12345, 2**63 - 2):
        t = tnative.negative_sample(ei, n, ei.shape[1], seed)
        assert t.dtype == np.int64 and t.shape == (2, ei.shape[1])
        np.testing.assert_array_equal(
            t, jnative.negative_sample(ei, n, ei.shape[1], seed))


def test_negative_sample_raises_where_the_graph_is_too_dense():
    n = 12
    full = np.array([(a, b) for a in range(n) for b in range(n) if a != b]).T
    for lib in (tnative, jnative):
        with pytest.raises(RuntimeError, match="non-edges"):
            lib.negative_sample(full[:, :100], n, 100, 0)


@pytest.mark.parametrize("layout", ["band", "bcsr"])
def test_native_builds_equal_the_numpy_branches(monkeypatch, layout):
    """build_graph through the library and through the numpy branches (the
    library unloaded): every edge array and layout array equal."""
    n = 5_000
    ei = graph("banded", n)
    kw = dict(materialize_bcsr=True, sparse_layout=layout, device="cpu")
    fast = tgraph.build_graph(ei, None, n, "gcn", **kw)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    slow = tgraph.build_graph(ei, None, n, "gcn", **kw)
    for name in ("row", "col", "weight"):
        assert getattr(fast, name).equal(getattr(slow, name)), name
    assert_graph_layouts_equal(fast, slow)
    part = fast.band if layout == "band" else fast.bcsr
    assert part is not None


def test_another_compiler_builds_a_library_of_its_own(monkeypatch, tmp_path):
    """The digest covers the compiler's path and its --version output: the
    RCM order's ties fall as the compiler's std::sort breaks them, so a
    library one compiler built is never loaded for another."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\n"
                   '[ "$1" = --version ] && { echo other-cxx 1.0; exit 0; }\n'
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    default = tnative.library_path()
    monkeypatch.setenv("CXX", str(cxx))
    assert tnative.compiler() == (str(cxx), "other-cxx 1.0\n")
    other = tnative.library_path()
    assert other.parent == default.parent and other != default
    assert other != tnative.library_path(tnative.SERIAL_FLAGS)
    assert tnative.library_path(cxx=(str(cxx), "other-cxx 1.1\n")) != other


def test_without_a_compiler_warns_once_and_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_SEARCHED", False)
    ei = graph("random", 300)
    with pytest.warns(RuntimeWarning, match="numpy and scipy branches"):
        assert not tnative.is_available()
    assert tnative.build_csr(ei, None, 300, "gcn") is None
    assert tnative.band_fill(ei[0], ei[1], np.ones(ei.shape[1]), 1, 1,
                             np.zeros(3, np.int32), 3) is None
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(jnative, "_load", lambda: None)
    np.testing.assert_array_equal(tnative.rcm_ordering(ei, 300),
                                  jnative.rcm_ordering(ei, 300))


def test_serial_build_where_openmp_is_refused(monkeypatch, tmp_path):
    """A compiler without an OpenMP runtime (one that refuses -fopenmp, as
    a g++ without libgomp does) gets the serial build, whose outputs are
    the JAX package's library's, byte for byte."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\n"
                   'for a in "$@"; do [ "$a" = -fopenmp ] && '
                   "{ echo no libgomp.spec >&2; exit 1; }; done\n"
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_SEARCHED", False)
    assert tnative.is_available()
    serial = tnative.library_path(tnative.SERIAL_FLAGS)
    assert tnative._load()._name == str(serial)
    assert "libgomp" in tnative.library_path().with_suffix(".log").read_text()
    n = 5_000
    ei = graph("banded", n)
    np.testing.assert_array_equal(tnative.rcm_ordering(ei, n),
                                  jnative.rcm_ordering(ei, n))
    for a, b in zip(tnative.build_csr(ei, None, n, "gcn"),
                    jnative.build_csr(ei, None, n, "gcn")):
        np.testing.assert_array_equal(a, b)
    row, col, w = sorted_coo(ei, n)
    wb, clo, _, _ = tband.band_stats(row, col, np.ones_like(row), n, 2)
    np.testing.assert_array_equal(
        tnative.band_fill(row, col, w, 2, wb, clo, clo.shape[0]),
        jnative.band_fill(row, col, w, 2, wb, clo, clo.shape[0]))
    np.testing.assert_array_equal(
        tbcsr.build_bcsr_arrays(row, col, w, n)["blocks"].numpy(),
        jspmm.build_bcsr_arrays(row, col, w, n)["blocks"])


class Built(Exception):
    """Stops a protocol run once its graph is built."""


def built_graph(monkeypatch, module, **kw):
    """(edge_index handed to build_graph, the Graph) of one protocol run
    on the RCM route: relabel with rcm_ordering, then the "pallas" route's
    planned layouts."""
    seen = {}
    real = module.build_graph

    def spy(edge_index, *a, **k):
        seen["edge_index"] = np.array(edge_index)
        seen["graph"] = real(edge_index, *a, **k)
        raise Built

    monkeypatch.setattr(module, "build_graph", spy)
    monkeypatch.setattr(module, "_auto_route",
                        lambda cfg, n, dev: ("pallas", True))
    with pytest.raises(Built):
        module.run_experiment(module.ExperimentConfig(**kw), log=lambda *_: 0)
    return seen["edge_index"], seen["graph"]


@pytest.mark.parametrize("layout", ["auto", "band", "bcsr"])
def test_rcm_route_builds_the_jax_protocols_graph(monkeypatch, tmp_path,
                                                  layout):
    write_subgnn(tmp_path, "ppi_bp", False, n_nodes=3_000, n_sub=30)
    monkeypatch.setenv("GLASS_CACHE_DIR", str(tmp_path / "cache"))
    kw = dict(dataset="ppi_bp", pool="sum", aggr="gcn", hidden_dim=8,
              conv_layer=1, dropout=0.0, batch_size=3, feature="deg",
              repeat=1, max_epochs=1, data_root=str(tmp_path),
              sparse_layout=layout)
    j_ei, jg = built_graph(monkeypatch, jprotocol, **kw)
    t_ei, tg = built_graph(monkeypatch, tprotocol, device="cpu", **kw)
    np.testing.assert_array_equal(t_ei, j_ei)
    for name in ("row", "col", "weight"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    assert_graph_layouts_equal(tg, jg)
    assert tg.bcsr is not None or tg.band is not None

"""The port's banded-slab layout and SpMM against glass_tpu's.

The same numpy inputs go through ``glass_tpu.ops.pallas_band`` /
``glass_tpu.ops.graph.build_graph`` and their counterparts in
``glass_tpu_torch``:

- the host functions and arrays: integers equal, slabs within 1 ulp (the
  JAX fill may be the native library's, which adds duplicate edges in
  another order);
- ``build_graph(sparse_layout="band")``: the same rps, window, affine law
  and arrays as the JAX builder, forward and transposed;
- ``band_spmm_reference`` (the CUDA kernel's plain version, which the
  wrapper runs for CPU tensors) against every f32 Pallas body in interpret
  mode, each forced as tests/test_pallas_band.py forces them, at rtol 1e-5
  and atol 1e-5 * max|x| (f32 sums in another order);
- dx through the port's autograd Functions against ``jax.grad`` of the JAX
  custom VJPs, rtol 1e-5.
The CUDA kernel itself is held against the same plain version on the card
by chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import glass_tpu.ops.pallas_band as pb
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.ops.spmm import spmm as jax_spmm
from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import band_spmm as tb
from glass_tpu_torch.ops import graph as tgraph
from glass_tpu_torch.ops.spmm import spmm

B = 128


def assert_ulp(a, b, ulps=1):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(np.abs(a - b) <= tol), float(np.abs(a - b).max())


def chain_edges(rng, n_comm, e=4000, csz=B):
    """A symmetric chain of communities (tests/test_pallas_band.py::
    chain_graph): an affine band with a negative offset and a bottom
    overhang at rps 2."""
    n = n_comm * csz
    intra = int(0.9 * e)
    ci = rng.integers(0, n_comm, intra)
    cx = rng.integers(0, n_comm - 1, e - intra)
    src = np.r_[ci * csz + rng.integers(0, csz, intra),
                cx * csz + rng.integers(0, csz, e - intra)]
    dst = np.r_[ci * csz + rng.integers(0, csz, intra),
                (cx + 1) * csz + rng.integers(0, csz, e - intra)]
    return np.stack([np.r_[src, dst], np.r_[dst, src]]), n


def piecewise_edges(rng, n=16 * B):
    """The recipe of tests/test_pallas_band.py::_piecewise_directed: the
    affine gate rejects it (per-group windows)."""
    half = n // 2
    r1 = np.arange(half)
    c1 = np.clip(r1 + rng.integers(-48, 48, half), 0, n - 1)
    r2 = np.arange(half, n)
    c2 = np.clip(r2 - half + rng.integers(-48, 48, half), 0, n - 1)
    return np.stack([np.r_[r1, r2], np.r_[c1, c2]]), n


def layout_case(name, rng):
    """(row, col, weight, n_node, rps) of a host-array case."""
    if name == "chain":
        ei, n = chain_edges(rng, 10)
        return ei[0], ei[1], rng.uniform(0.5, 2, ei.shape[1]), n, 2
    if name == "piecewise":
        ei, n = piecewise_edges(rng)
        return ei[0], ei[1], rng.uniform(0.5, 2, ei.shape[1]), n, 2
    if name == "empty_groups_ragged":
        # n % 128 != 0; row blocks 2-5 hold no edge; 6 groups of rps 2, so
        # the forced multi-group bodies below (2 groups a step) cover all
        n = 11 * B + 51
        r = rng.integers(0, n, 3000)
        r = r[(r // B < 2) | (r // B > 5)]
        c = np.clip(r + rng.integers(-150, 150, r.size), 0, n - 1)
        return r, c, rng.uniform(0.5, 2, r.size), n, 2
    if name == "duplicates_and_zeros":
        n = 6 * B
        r = rng.integers(0, n, 1500)
        c = np.clip(r + rng.integers(-100, 100, r.size), 0, n - 1)
        r, c = np.r_[r, r[:300]], np.r_[c, c[:300]]
        w = rng.uniform(0.1, 2, r.size)
        w[::9] = 0.0
        return r, c, w, n, 1
    raise KeyError(name)


CASES = ["chain", "piecewise", "empty_groups_ragged", "duplicates_and_zeros"]


@pytest.mark.parametrize("name", CASES)
def test_host_functions_match(rng, name):
    r, c, w, n, rps = layout_case(name, rng)
    keep = w != 0
    span_j = pb.rowblock_spans(r[keep], c[keep], n)
    span_t = tb.rowblock_spans(r[keep], c[keep], n)
    for a, b in zip(span_j, span_t):
        np.testing.assert_array_equal(a, b)
    g = (r // B) // rps
    for a, b in zip(pb._group_minmax(g, c // B, -(-n // B // rps) + 1, 9),
                    tb._group_minmax(g, c // B, -(-n // B // rps) + 1, 9)):
        np.testing.assert_array_equal(a, b)
    for p in (1, 2, 4):
        for span in (None, span_t):
            ja = pb.band_stats(r, c, w, n, p, rb_span=span)
            ta = tb.band_stats(r, c, w, n, p, rb_span=span)
            assert ja[0] == ta[0] and ja[2:] == ta[2:]
            np.testing.assert_array_equal(ja[1], ta[1])
            assert pb.affine_fit(r, c, w, n, p, rb_span=span) == \
                tb.affine_fit(r, c, w, n, p, rb_span=span)
        wb = ta[0]
        np.testing.assert_array_equal(
            pb.window_starts(r[keep], c[keep], n, p, wb),
            tb.window_starts(r[keep], c[keep], n, p, wb))
        with pytest.raises(ValueError, match="exceeds"):
            tb.window_starts(r[keep], c[keep], n, p, 0)
        for h_pad in (128, 256):
            assert pb.band_vmem_ok(p, wb, h_pad, 4) == \
                tb.band_vmem_ok(p, wb, h_pad, 4)
    np.testing.assert_array_equal(pb.affine_clo(7, 3, -2),
                                  tb.affine_clo(7, 3, -2))


@pytest.mark.parametrize("affine", [False, True], ids=["per_group", "affine"])
@pytest.mark.parametrize("name", CASES)
def test_build_band_matches(rng, name, affine):
    r, c, w, n, rps = layout_case(name, rng)
    fit = tb.affine_fit(r, c, w, n, rps) if affine else None
    jb = pb.build_band(r, c, w, n, rps, affine=fit)
    t = tb.build_band(r, c, w, n, rps, affine=fit)
    assert (t.n_rb, t.n_cb, t.rps, t.w_blocks, t.n_groups) == \
        (jb.n_rb, jb.n_cb, jb.rps, jb.w_blocks, jb.n_groups)
    assert (t.affine_stride, t.affine_off) == (jb.affine_stride, jb.affine_off)
    np.testing.assert_array_equal(t.clo.numpy(), np.asarray(jb.clo))
    assert_ulp(t.slabs.numpy(), np.asarray(jb.slabs))


def test_layout_cases_are_present(rng):
    r, c, w, n, rps = layout_case("chain", rng)
    stride, off, wb = tb.affine_fit(r, c, w, n, rps)
    n_g = -(-(-(-n // B)) // rps)
    assert off < 0 and (n_g - 1) * stride + off + wb > -(-n // B)
    r, c, w, n, rps = layout_case("empty_groups_ragged", rng)
    slabs = tb.build_band(r, c, w, n, rps).slabs
    assert n % B and (slabs.abs().sum(dim=(1, 2)) == 0).any()


def test_builder_rejects_what_it_cannot_hold(rng):
    with pytest.raises(ValueError, match="lie in"):
        tb.build_band_arrays(np.array([0, 5]), np.array([1, 2]), np.ones(2), 5,
                             rps=1)
    with pytest.raises(ValueError, match="forced band window"):
        tb.build_band_arrays(np.array([0]), np.array([300]), np.ones(1),
                             400, rps=1, window=(1, np.zeros(4, np.int32)))
    q = tb.build_band_arrays(np.array([0]), np.array([0]), np.ones(1), 4,
                             rps=1, dtype="int8")  # int8 is ported now
    assert q["slabs"].dtype == torch.int8 and q["slabs"][0, 0, 0] == 127
    with pytest.raises(ValueError, match="dtype"):
        tb.build_band_arrays(np.array([0]), np.array([0]), np.ones(1), 4,
                             rps=1, dtype="float16")
    with pytest.raises(NotImplementedError, match="item 12"):
        tb.build_band_arrays(np.array([0]), np.array([0]), np.ones(1), 4,
                             rps=1, trim_groups=(0, 1))


# ------------------------------------------------------------- build_graph


def infeasible_transpose_edges(rng, n=64 * B):
    """Every row points into column block 32: the forward band is one block
    wide, the transpose's spans all 64 column blocks, past the layout rule
    at every rps (tests/test_pallas_band.py:259 at a smaller size)."""
    return np.stack([np.arange(n), 32 * B + rng.integers(0, B, n)]), n


GRAPHS = {
    "chain_gcn": lambda rng: (*chain_edges(rng, 10), "gcn"),
    "piecewise_sum": lambda rng: (*piecewise_edges(rng), "sum"),
    "chain_mean": lambda rng: (*chain_edges(rng, 10), "mean"),
}


def assert_band_equal(t, j):
    assert (t.rps, t.w_blocks, t.affine_stride, t.affine_off, t.n_node) == \
        (j.rps, j.w_blocks, j.affine_stride, j.affine_off, j.n_node)
    np.testing.assert_array_equal(t.clo.numpy(), np.asarray(j.clo))
    assert_ulp(t.slabs.numpy(), np.asarray(j.slabs))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_graph_band_matches_jax(rng, name):
    ei, n, aggr = GRAPHS[name](rng)
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout="band")
    jg = jax_build_graph(ei, None, n, aggr, **kw)
    tg = tgraph.build_graph(ei, None, n, aggr, device="cpu", **kw)
    assert tg.bcsr is None and tg.bcsr_t is None
    assert_band_equal(tg.band, jg.band)
    assert_band_equal(tg.band_t, jg.band_t)
    assert (tg.band_t is tg.band) == (name == "chain_gcn")  # symmetric A
    if name == "chain_gcn":
        assert tg.band.affine_stride is not None and tg.band.affine_off < 0
    if name == "piecewise_sum":
        assert tg.band.affine_stride is None


def test_build_graph_band_rps_is_taken(rng):
    ei, n = chain_edges(rng, 8)
    tg = tgraph.build_graph(ei, None, n, "gcn", materialize_dense=False,
                            materialize_bcsr=True, sparse_layout="band",
                            band_rps=4, device="cpu")
    jg = jax_build_graph(ei, None, n, "gcn", materialize_dense=False,
                         materialize_bcsr=True, sparse_layout="band",
                         band_rps=4)
    assert tg.band.rps == 4
    assert_band_equal(tg.band, jg.band)


def test_infeasible_transpose_falls_back_to_bcsr(rng):
    """The transpose has no band that passes the layout rule: BCSR both
    ways, as the JAX builder's auto plan gives (its forced-band plan would
    build an rps-8 transpose past the gate)."""
    ei, n = infeasible_transpose_edges(rng)
    tg = tgraph.build_graph(ei, None, n, "sum", materialize_dense=False,
                            materialize_bcsr=True, sparse_layout="band",
                            device="cpu")
    assert tg.band is None and tg.band_t is None
    assert tg.bcsr is not None and tg.bcsr_t is not tg.bcsr
    assert tgraph.plan_band_rps(ei[0], ei[1], np.ones(n), n) is not None
    assert tgraph.plan_band_rps(ei[1], ei[0], np.ones(n), n) is None
    jg = jax_build_graph(ei, None, n, "sum", materialize_dense=False,
                         materialize_bcsr=True, sparse_layout="auto")
    assert jg.band is None and jg.band_t is None
    for t, j in ((tg.bcsr, jg.bcsr), (tg.bcsr_t, jg.bcsr_t)):
        np.testing.assert_array_equal(t.block_col.numpy(),
                                      np.asarray(j.block_col))
        assert_ulp(t.blocks.numpy(), np.asarray(j.blocks))


# --------------------------------------------------------------- the SpMM


@pytest.fixture
def body(request, monkeypatch):
    """Forces one Pallas body of ``pallas_band.band_spmm``: returns
    (name, stripes). The per-group bodies are chosen by the VMEM budget and
    the groups per step (``_pick_gps``)."""
    name = request.param
    if name in ("gps", "streamed", "striped"):
        monkeypatch.setattr(pb, "_VMEM_BUDGET", 1)  # x windows streamed
    if name in ("xvmem_gps", "gps"):
        monkeypatch.setattr(pb, "_pick_gps", lambda *a: 2)
    if name in ("xvmem", "streamed"):
        monkeypatch.setattr(pb, "_pick_gps", lambda *a: 1)
    pb.band_spmm.clear_cache()
    yield name, 2 if name == "striped" else 1
    pb.band_spmm.clear_cache()


BODIES = ["affine", "xvmem_gps", "xvmem", "gps", "streamed", "striped"]


@pytest.mark.parametrize("body", BODIES, indirect=True)
@pytest.mark.parametrize("h", [8, 17, 64, 128])
def test_reference_matches_pallas(rng, body, h):
    name, stripes = body
    if name == "affine":  # negative offset, bottom overhang
        r, c, w, n, rps = layout_case("chain", rng)
        fit = tb.affine_fit(r, c, w, n, rps)
    else:  # per-group windows, n % 128 != 0, empty groups
        r, c, w, n, rps = layout_case("empty_groups_ragged", rng)
        fit = None
    jb = pb.build_band(r, c, w, n, rps, affine=fit)
    t = tb.build_band(r, c, w, n, rps, affine=fit)
    x = rng.normal(size=(n, h)).astype(np.float32)
    ref = np.asarray(pb.band_spmm(jb, jnp.asarray(x), interpret=True,
                                  stripes=stripes))
    launches = tb.band_spmm.launches
    out = tb.band_spmm(t, torch.from_numpy(x))
    assert tb.band_spmm.launches == launches  # CPU: plain version, no launch
    assert out.shape == (n, h) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(x).max())
    np.testing.assert_array_equal(
        out.numpy(), tb.band_spmm_reference(t, torch.from_numpy(x)).numpy())


def test_empty_x_and_outside_rows_read_zero(rng):
    r, c, w, n, rps = layout_case("chain", rng)
    t = tb.build_band(r, c, w, n, rps, affine=tb.affine_fit(r, c, w, n, rps))
    assert not tb.band_spmm(t, torch.zeros(0, 3)).any()
    x = torch.randn(n, 3)
    half = n // 2  # rows of x past its end read as zero
    np.testing.assert_allclose(
        tb.band_spmm(t, x[:half].contiguous()).numpy(),
        tb.band_spmm(t, torch.cat([x[:half], torch.zeros(n - half, 3)])).numpy(),
        rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["band", "bcsr"])
def test_autograd_dx_matches_jax_grad(rng, layout):
    ei, n = chain_edges(rng, 8)
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout=layout)
    jg = jax_build_graph(ei, None, n, "mean", **kw)
    tg = tgraph.build_graph(ei, None, n, "mean", device="cpu", **kw)
    fwd, bwd = (tg.band, tg.band_t) if layout == "band" else (tg.bcsr, tg.bcsr_t)
    assert fwd is not None and bwd is not fwd  # asymmetric: A^T is its own
    mode = "band" if layout == "band" else "pallas"
    x = rng.normal(size=(n, 17)).astype(np.float32)
    w = rng.normal(size=(n, 17)).astype(np.float32)
    ref = np.asarray(jax.grad(
        lambda v: (jax_spmm(jg, v, mode) * w).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (spmm(tg, xt, mode) * torch.from_numpy(w)).sum().backward()
    assert xt.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_autograd_refuses_what_it_cannot_differentiate(rng):
    r, c, w, n, rps = layout_case("chain", rng)
    t = tb.build_band(r, c, w, n, rps)
    with pytest.raises(RuntimeError, match="transposed layout"):
        tb.band_spmm(t, torch.zeros(n, 4, requires_grad=True))
    with pytest.raises(ValueError, match="rows"):
        tb.band_spmm(t, torch.zeros(n - 1, 4, requires_grad=True), t)
    leafy = tb.BandedAdj(**{**t.__dict__,
                            "slabs": t.slabs.clone().requires_grad_()})
    with pytest.raises(RuntimeError, match="no gradient for the layout"):
        tb.band_spmm(leafy, torch.zeros(n, 4))


def test_wrapper_refuses_types_strides_and_devices(rng):
    r, c, w, n, rps = layout_case("chain", rng)
    t = tb.build_band(r, c, w, n, rps)
    with pytest.raises(TypeError, match="float32"):
        tb.band_spmm(t, torch.zeros(n, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tb.band_spmm(t, torch.zeros(4, n).t())
    with pytest.raises(ValueError, match="rows"):
        tb.band_spmm(t, torch.zeros(t.n_cb * B + 1, 4))
    with pytest.raises(ValueError, match="one device"):
        tb.band_spmm(t, torch.zeros(n, 4, device="meta"))


def test_kernel_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tb._kernel()
    assert "band_spmm" in _build.SOURCES

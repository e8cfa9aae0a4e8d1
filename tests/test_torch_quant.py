"""The port's bf16 and int8 adjacencies against glass_tpu's.

The same numpy inputs go through the JAX builders, kernels and model and
their counterparts in ``glass_tpu_torch``:

- the layouts: int8 values byte for byte, bf16 values and scales equal
  (the JAX band scales as ``row_scale[:, :, 0]``, the dense ones as
  ``scale[:, 0]``), for the band (affine with a negative offset and a
  bottom overhang, per-group, empty groups with n % 128 != 0, duplicates),
  BCSR and the int8 dense layout, and ``build_graph(dense_dtype=...)``'s
  choice of layout, rps, window and affine law, the int8-infeasible rule
  included;
- the kernels' plain versions (which the wrappers run for CPU tensors)
  against the Pallas bodies in interpret mode, each forced as
  tests/test_pallas_band.py forces them: every slab type (f32, bf16, int8)
  with f32 and bf16 x, within 1e-5 * max|JAX| (f32 sums of exact products
  in another order); dx through the autograd Functions against
  ``jax.grad``, in x's dtype, within 1e-5 * max|JAX| for f32 x, and for
  bf16 x within one bf16 ulp of each value (the same f32 sum, taken in
  another order, may round to the neighbouring bf16 value);
- GLASS with an int8 adjacency and f32 compute against flax: logits within
  rtol 1e-4 and atol 1e-3 * max|logit|, parameter gradients within rtol
  1e-4 and atol 5e-2 * max|grad| of each tensor. The kernels round their x
  (forward) and cotangent (backward) to bf16, and the two frameworks'
  f32 values of those differ in their last bits (sums in another order),
  so now and then one rounds to the neighbouring bf16 value, a change of
  2^-8 in that element. Measured over seeds 0-3 on the band, BCSR and dense
  layouts: logits within 1.6e-4 * max|logit|, gradients within
  3.2e-2 * max|grad| (1.1e-6 where no rounding flips); the SpMM itself is
  held at 1e-5 above.
bf16 compute is held against flax in tests/test_torch_model.py and
tests/test_torch_train.py. The CUDA kernels themselves are held against
the same plain versions on the card by chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import glass_tpu.ops.pallas_band as pb
import glass_tpu.ops.pallas_dense as pd
import glass_tpu.ops.pallas_spmm as ps
from glass_tpu.nn.modules import GLASS as FlaxGLASS
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.ops.labeling import max_zero_one as jax_max_zero_one
from glass_tpu.ops.spmm import spmm as jax_spmm
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import GLASS, params_from_flax
from glass_tpu_torch.ops import band_spmm as tb
from glass_tpu_torch.ops import bcsr_spmm as tbs
from glass_tpu_torch.ops import dense_q as tdq
from glass_tpu_torch.ops import graph as tgraph
from glass_tpu_torch.ops.spmm import spmm
from glass_tpu_torch.utils.checkpoint import _torch_key
from test_torch_band import GRAPHS, chain_edges, layout_case
from test_torch_graph import case_edges

B = 128
BAND_CASES = ["chain", "piecewise", "empty_groups_ragged",
              "duplicates_and_zeros"]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def assert_within(out, ref, x_dtype="float32"):
    """out within 1e-5 * max|ref| of ref; bf16 values may also sit one bf16
    ulp away (see the module docstring)."""
    out, ref = f32(out), f32(ref)
    assert out.shape == ref.shape
    tol = 1e-5 * np.abs(ref).max() + 1e-30
    if x_dtype == "bfloat16":
        tol = tol + 2.0 ** -8 * np.abs(ref)
    assert np.all(np.abs(out - ref) <= tol), float(np.abs(out - ref).max())


def assert_band_arrays_equal(t, j):
    assert (t.rps, t.w_blocks, t.affine_stride, t.affine_off, t.n_node) == \
        (j.rps, j.w_blocks, j.affine_stride, j.affine_off, j.n_node)
    np.testing.assert_array_equal(t.clo.numpy(), np.asarray(j.clo))
    if t.slabs.dtype == torch.int8:
        assert np.asarray(j.slabs).dtype == np.int8
        np.testing.assert_array_equal(t.slabs.numpy(), np.asarray(j.slabs))
        np.testing.assert_array_equal(
            t.row_scale.numpy(), f32(j.row_scale[:, :, 0]).reshape(-1))
    else:
        assert t.row_scale is None and j.row_scale is None
        assert str(np.asarray(j.slabs).dtype) == \
            str(t.slabs.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(t.slabs.float().numpy(), f32(j.slabs))


# ------------------------------------------------------------------ layouts


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("affine", [False, True], ids=["per_group", "affine"])
@pytest.mark.parametrize("name", BAND_CASES)
def test_band_arrays_match(rng, name, affine, dtype):
    r, c, w, n, rps = layout_case(name, rng)
    fit = tb.affine_fit(r, c, w, n, rps) if affine else None
    jb = pb.build_band(r, c, w, n, rps, dtype, affine=fit)
    t = tb.build_band(r, c, w, n, rps, affine=fit, dtype=dtype)
    assert_band_arrays_equal(t, jb)
    if dtype == "int8":  # an all-zero row quantizes with scale 1
        zero_rows = ~t.slabs.reshape(-1, t.slabs.shape[-1]).any(dim=1)
        if name == "empty_groups_ragged":
            assert zero_rows.any()
        assert (t.row_scale[zero_rows] == 1).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", ["random", "empty_row_blocks", "ragged_n",
                                  "duplicates_and_zeros", "wide_row",
                                  "no_edges"])
def test_bcsr_arrays_match(rng, case, dtype):
    ei, w, n = case_edges(case, rng)
    w = np.ones(ei.shape[1], np.float32) if w is None else w
    wn = tgraph.normalized_edge_weight(ei, w, n, "mean")  # asymmetric
    ref = ps.build_bcsr_arrays(ei[0], ei[1], wn, n, dtype)
    out = tbs.build_bcsr_arrays(ei[0], ei[1], wn, n, dtype)
    for key in ("block_col", "block_row_ptr", "chunk_start", "chunk_len"):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    if dtype == "int8":
        np.testing.assert_array_equal(out["blocks"].numpy(), ref["blocks"])
        np.testing.assert_array_equal(out["row_scale"], ref["row_scale"])
    else:
        assert out["row_scale"] is None and ref["row_scale"] is None
        assert out["blocks"].dtype == torch.bfloat16
        np.testing.assert_array_equal(out["blocks"].float().numpy(),
                                      f32(ref["blocks"]))


@pytest.mark.parametrize("case", ["random", "ragged_n", "empty_row_blocks",
                                  "duplicates_and_zeros"])
def test_dense_q_arrays_match(rng, case):
    ei, w, n = case_edges(case, rng)
    w = np.ones(ei.shape[1], np.float32) if w is None else w
    wn = tgraph.normalized_edge_weight(ei, w, n, "mean")
    d = np.zeros((n, n), np.float32)
    np.add.at(d, (ei[0], ei[1]), wn)
    for m in (d, d.T):
        ref = pd.build_dense_q(m)
        out = tdq.build_dense_q(m)
        assert (out.n_row, out.n_col) == (ref.n_row, ref.n_col)
        np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
        np.testing.assert_array_equal(out.scale.numpy(),
                                      np.asarray(ref.scale)[:, 0])
    assert tdq.dense_q_bytes(n, n) == pd.dense_q_bytes(n, n)
    for cols in (n, 20_000, 40_000):
        for hp in (64, 128, 256):
            assert tdq.dense_q_vmem_ok(n, cols, hp) == \
                pd.dense_q_vmem_ok(n, cols, hp), (cols, hp)


# -------------------------------------------------------------- build_graph


@pytest.mark.parametrize("dense_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_graph_band_dtype_matches_jax(rng, name, dense_dtype):
    ei, n, aggr = GRAPHS[name](rng)
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout="band", dense_dtype=dense_dtype)
    jg = jax_build_graph(ei, None, n, aggr, **kw)
    tg = tgraph.build_graph(ei, None, n, aggr, device="cpu", **kw)
    assert tg.bcsr is None and jg.bcsr is None
    assert_band_arrays_equal(tg.band, jg.band)
    assert_band_arrays_equal(tg.band_t, jg.band_t)
    assert (tg.band_t is tg.band) == (name == "chain_gcn")


def itemsize_sensitive_edges(n=13 * B):
    """A band whose ranking cost puts rps 1 first at the f32 itemsize and
    rps 2 at bf16's (the slab stream term halves), found by a search over
    random bands."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, n, 5216)
    dst = np.clip(src + rng.integers(-333, 333, src.size), 0, n - 1)
    return np.stack([np.r_[src, dst], np.r_[dst, src]]), n


def test_plan_itemsize_follows_the_dtype():
    """The planner ranks candidates at the dtype's itemsize (2 for bf16
    and int8), as the JAX plan does; on this graph that changes rps."""
    ei, n = itemsize_sensitive_edges()
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout="band")
    rps = {}
    for dd in ("f32", "bf16", "int8"):
        jg = jax_build_graph(ei, None, n, "gcn", dense_dtype=dd, **kw)
        tg = tgraph.build_graph(ei, None, n, "gcn", dense_dtype=dd,
                                device="cpu", **kw)
        assert (tg.band.rps, tg.band.w_blocks, tg.band.affine_stride) == \
            (jg.band.rps, jg.band.w_blocks, jg.band.affine_stride), dd
        rps[dd] = tg.band.rps
    assert rps["bf16"] == rps["int8"] != rps["f32"], rps


@pytest.mark.parametrize("dense_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("aggr", ["gcn", "mean"])
def test_build_graph_bcsr_dtype_matches_jax(rng, aggr, dense_dtype):
    ei, _, n = case_edges("random", rng)
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout="bcsr", dense_dtype=dense_dtype)
    jg = jax_build_graph(ei, None, n, aggr, **kw)
    tg = tgraph.build_graph(ei, None, n, aggr, device="cpu", **kw)
    assert (tg.bcsr_t is tg.bcsr) == (aggr == "gcn")
    for t, j in ((tg.bcsr, jg.bcsr), (tg.bcsr_t, jg.bcsr_t)):
        np.testing.assert_array_equal(t.block_col.numpy(),
                                      np.asarray(j.block_col))
        np.testing.assert_array_equal(t.blocks.float().numpy(), f32(j.blocks))
        if dense_dtype == "int8":
            np.testing.assert_array_equal(t.row_scale.numpy(),
                                          np.asarray(j.row_scale))
        else:
            assert t.row_scale is None and j.row_scale is None


@pytest.mark.parametrize("feasible", [True, False],
                         ids=["int8_layout", "int8_infeasible_bf16_dense"])
@pytest.mark.parametrize("aggr", ["gcn", "mean"])
def test_build_graph_dense_dtype_matches_jax(rng, monkeypatch, aggr, feasible):
    """int8 builds the row-quantized layout where the reference's layout
    rule holds, and the bf16 dense matrix where it does not (a budget
    shrunk in both packages puts this graph past the rule)."""
    if not feasible:
        monkeypatch.setattr(pb, "_VMEM_BUDGET", 400_000)
        monkeypatch.setattr(tb, "LAYOUT_BUDGET_BYTES", 400_000)
    ei, _, n = case_edges("random", rng)
    jg = jax_build_graph(ei, None, n, aggr, materialize_dense=True,
                         dense_dtype="int8")
    tg = tgraph.build_graph(ei, None, n, aggr, materialize_dense=True,
                            dense_dtype="int8", device="cpu")
    if feasible:
        assert tg.dense is None and jg.dense is None
        assert (tg.dense_q_t is tg.dense_q) == (aggr == "gcn") == \
            (jg.dense_q_t is jg.dense_q)
        for t, j in ((tg.dense_q, jg.dense_q), (tg.dense_q_t, jg.dense_q_t)):
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(t.scale.numpy(),
                                          np.asarray(j.scale)[:, 0])
    else:
        assert tg.dense_q is None and jg.dense_q is None
        assert tg.dense.dtype == torch.bfloat16
        np.testing.assert_array_equal(tg.dense.float().numpy(), f32(jg.dense))
    bf = tgraph.build_graph(ei, None, n, aggr, materialize_dense=True,
                            dense_dtype="bf16", device="cpu")
    jbf = jax_build_graph(ei, None, n, aggr, materialize_dense=True,
                          dense_dtype="bf16")
    np.testing.assert_array_equal(bf.dense.float().numpy(), f32(jbf.dense))


# ------------------------------------------------- plain versions vs Pallas


@pytest.fixture
def body(request, monkeypatch):
    """Forces one Pallas body of ``pallas_band.band_spmm`` (as in
    tests/test_torch_band.py): "affine" (``_band_kernel_affine`` or, for
    int8, ``_band_kernel_affine_q``), "xvmem" (x resident) or "streamed"
    (x windows streamed)."""
    name = request.param
    if name == "streamed":
        monkeypatch.setattr(pb, "_VMEM_BUDGET", 1)
    if name != "affine":
        monkeypatch.setattr(pb, "_pick_gps", lambda *a: 1)
    pb.band_spmm.clear_cache()
    yield name
    pb.band_spmm.clear_cache()


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slab_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("body", ["affine", "xvmem", "streamed"],
                         indirect=True)
def test_band_reference_matches_pallas(rng, body, slab_dtype, x_dtype):
    if body == "affine":  # negative offset, bottom overhang
        r, c, w, n, rps = layout_case("chain", rng)
        fit = tb.affine_fit(r, c, w, n, rps)
    else:  # per-group windows, n % 128 != 0, empty groups
        r, c, w, n, rps = layout_case("empty_groups_ragged", rng)
        fit = None
    jb = pb.build_band(r, c, w, n, rps, slab_dtype, affine=fit)
    t = tb.build_band(r, c, w, n, rps, affine=fit, dtype=slab_dtype)
    x = jnp.asarray(rng.normal(size=(n, 17)).astype(np.float32)).astype(
        x_dtype)
    ref = pb.band_spmm(jb, x, interpret=True)
    launches = tb.band_spmm.launches
    out = tb.band_spmm(t, torch.from_numpy(f32(x)).to(TORCH_DTYPES[x_dtype]))
    assert tb.band_spmm.launches == launches  # CPU: plain version
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert_within(out.numpy(), ref)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("streamed", [False, True],
                         ids=["resident", "streamed"])
def test_bcsr_reference_matches_pallas(rng, monkeypatch, streamed,
                                       block_dtype, x_dtype):
    if streamed:
        monkeypatch.setattr(ps, "_X_VMEM_LIMIT_BYTES", 1)
    ps.bcsr_spmm.clear_cache()
    ei, w, n = case_edges("wide_row", rng)
    wn = tgraph.normalized_edge_weight(ei, np.ones(ei.shape[1]), n, "mean")
    jb = ps.build_bcsr(ei[0], ei[1], wn, n, dtype=block_dtype)
    t = tbs.build_bcsr(ei[0], ei[1], wn, n, dtype=block_dtype)
    x = jnp.asarray(rng.normal(size=(n, 17)).astype(np.float32)).astype(
        x_dtype)
    ref = ps.bcsr_spmm(jb, x, interpret=True)
    ps.bcsr_spmm.clear_cache()
    out = tbs.bcsr_spmm(t, torch.from_numpy(f32(x)).to(TORCH_DTYPES[x_dtype]))
    assert out.dtype == torch.float32
    assert_within(out.numpy(), ref)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [17, 130])
def test_dense_q_reference_matches_pallas(rng, h, x_dtype):
    ei, w, n = case_edges("ragged_n", rng)
    wn = tgraph.normalized_edge_weight(ei, w, n, "mean")
    d = np.zeros((n, n), np.float32)
    np.add.at(d, (ei[0], ei[1]), wn)
    jq, t = pd.build_dense_q(d), tdq.build_dense_q(d)
    x = jnp.asarray(rng.normal(size=(n, h)).astype(np.float32)).astype(x_dtype)
    ref = pd.dense_q_spmm(jq, jq, x, True)
    launches = tdq.dense_q_spmm.launches
    out = tdq.dense_q_spmm(t, None,
                           torch.from_numpy(f32(x)).to(TORCH_DTYPES[x_dtype]))
    assert tdq.dense_q_spmm.launches == launches
    assert out.shape == (n, h) and out.dtype == torch.float32
    assert_within(out.numpy(), ref)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout, dense_dtype", [
    ("band", "bf16"), ("band", "int8"), ("bcsr", "bf16"), ("bcsr", "int8"),
    ("dense", "int8"), ("dense", "bf16")])
def test_autograd_dx_matches_jax_grad(rng, layout, dense_dtype, x_dtype):
    """dx = A^T g on an asymmetric ("mean") graph, through each autograd
    Function (and the bf16 dense product), in x's dtype."""
    ei, n = chain_edges(rng, 8)
    kw = (dict(materialize_dense=True) if layout == "dense" else
          dict(materialize_dense=False, materialize_bcsr=True,
               sparse_layout=layout))
    jg = jax_build_graph(ei, None, n, "mean", dense_dtype=dense_dtype, **kw)
    tg = tgraph.build_graph(ei, None, n, "mean", dense_dtype=dense_dtype,
                            device="cpu", **kw)
    fwd, bwd = {"band": (tg.band, tg.band_t), "bcsr": (tg.bcsr, tg.bcsr_t),
                "dense": (tg.dense_q, tg.dense_q_t)}[layout]
    if (layout, dense_dtype) != ("dense", "bf16"):
        assert fwd is not None and bwd is not fwd  # A^T is its own layout
    mode = {"band": "band", "bcsr": "pallas", "dense": "dense"}[layout]
    x = jnp.asarray(rng.normal(size=(n, 17)).astype(np.float32)).astype(
        x_dtype)
    w = rng.normal(size=(n, 17)).astype(np.float32)
    ref = jax.grad(lambda v: (jax_spmm(jg, v, mode) * w).sum())(x)
    xt = torch.from_numpy(f32(x)).to(TORCH_DTYPES[x_dtype]).requires_grad_()
    out = spmm(tg, xt, mode)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(w)).sum().backward()
    assert xt.grad.dtype == TORCH_DTYPES[x_dtype] and ref.dtype == x.dtype
    assert_within(xt.grad.float().numpy(), ref, x_dtype)


# ------------------------------------------------------------------- model

N_NODE, MAX_DEG, HIDDEN, LAYERS = 300, 7, 16, 2


def model_inputs(rng):
    src = rng.integers(0, N_NODE, 1200)
    dst = np.clip(src + rng.integers(-60, 60, src.size), 0, N_NODE - 1)
    ei = np.stack([np.r_[src, dst], np.r_[dst, src]])
    x = rng.integers(0, MAX_DEG + 1, (N_NODE, 1))
    pos = np.full((5, 12), -1, np.int64)
    for i in range(4):  # the last row is batch padding
        k = int(rng.integers(2, 13))
        pos[i, :k] = rng.choice(N_NODE, k, replace=False)
    return ei, x, pos


@pytest.mark.parametrize("layout", ["band", "bcsr", "dense"])
def test_glass_int8_adjacency_matches_flax(rng, layout):
    """GLASS with f32 compute on an int8 adjacency (asymmetric "mean", so
    the backward runs over the transposed layouts): logits and parameter
    gradients within rtol 1e-4 of flax."""
    ei, x, pos = model_inputs(rng)
    kw = (dict(materialize_dense=True) if layout == "dense" else
          dict(materialize_dense=False, materialize_bcsr=True,
               sparse_layout=layout))
    jg = jax_build_graph(ei, None, N_NODE, "mean", dense_dtype="int8", **kw)
    tg = tgraph.build_graph(ei, None, N_NODE, "mean", dense_dtype="int8",
                            device="cpu", **kw)
    held = {"band": tg.band, "bcsr": tg.bcsr, "dense": tg.dense_q}[layout]
    assert held is not None and (held.slabs if layout == "band" else
                                 held.blocks if layout == "bcsr"
                                 else held.q).dtype == torch.int8
    mode = "dense" if layout == "dense" else "pallas"
    z = jax_max_zero_one(jnp.asarray(pos), N_NODE)
    fm = FlaxGLASS(max_deg=MAX_DEG, hidden_channels=HIDDEN, num_layers=LAYERS,
                   output_channels=(3,), pools=("size",), dropout=0.0,
                   activation="elu", z_ratio=0.8, jk=True, spmm_mode=mode)
    params = fm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                     jnp.asarray(pos), z)
    w = rng.normal(size=(5, 3)).astype(np.float32)

    def loss(p):
        out = fm.apply(p, jg, jnp.asarray(x), jnp.asarray(pos), z)
        return (out * w).sum(), out

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(params)
    tm = params_from_flax(
        GLASS(MAX_DEG, HIDDEN, LAYERS, (3,), ("size",), activation="elu",
              z_ratio=0.8, jk=True, spmm_mode=mode, device="cpu"),
        _flatten(params))
    out = tm(tg, torch.from_numpy(x), torch.from_numpy(pos),
             torch.from_numpy(np.array(z)))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-3 * np.abs(ref).max())
    (out * torch.from_numpy(w)).sum().backward()
    tgrads = dict(tm.named_parameters())
    for key, g in _flatten(grads).items():
        name, transpose = _torch_key(key)
        g = g.T if transpose else g
        np.testing.assert_allclose(tgrads[name].grad.numpy(), g, rtol=1e-4,
                                   atol=5e-2 * np.abs(g).max(), err_msg=name)

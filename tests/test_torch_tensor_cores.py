"""The numerics of the port's two tensor-core SpMM kernels and their wrappers,
on the CPU (the kernels themselves run only on the card, where
chip_smoke.py holds them against their plain versions).

- The f32 band kernel (``csrc/band_spmm.cu``) multiplies f32 slabs as three
  TF32 products, a_hi*x_hi + a_hi*x_lo + a_lo*x_hi with hi = tf32_rna(v)
  and lo = tf32_rna(v - hi). A torch emulation of that split (``tf32_rna``
  in integer bit operations: round to nearest, ties away from zero; the
  three products summed in f64) stays within 1e-6 * max|plain| of
  ``band_spmm_reference`` on small band layouts of
  ``bench.py::clustered_graph``'s recipe, on the host-array cases of
  tests/test_torch_band.py and on a layout whose values span 2^-20 to 2^4;
  and within 1e-5 * max|JAX| of the f32 Pallas body in interpret mode.
- The f32 BCSR kernel (``csrc/bcsr_spmm.cu``) runs the same 3xTF32 stages
  over each row block's live blocks only (up to ``block_row_end``). A torch
  emulation of that walk stays within 1e-6 * max|plain| of
  ``bcsr_spmm_reference`` and within 1e-5 * max|JAX| of the f32 Pallas BCSR
  body in interpret mode, at H = 8, 17, 64 and 128, also on a layout whose
  values span 2^-20 to 2^4.
- The bf16 and int8 layouts' kernels (BCSR and band) read x rounded to
  bf16 once by the wrapper (``band_spmm.mma_x_operand``), as
  ``band_spmm.x_operand`` rounds it, rows padded to a multiple of 8 values.
- The int8 dense kernel (``csrc/dense_q_spmm.cu``): the wrapper's one-time
  bf16 rounding of x (``dense_q.x_operand``) equals
  ``band_spmm.x_operand``'s, transposed and zero-padded along k; the
  layout's plain version matches the Pallas kernel in interpret mode at
  the shapes chip_smoke.py checks the kernel at.
- The calibration file's default path is keyed by the timed kernels'
  source digests: an edited ``.cu`` gives a new path.
"""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import glass_tpu.ops.pallas_band as pb
import glass_tpu.ops.pallas_dense as pd
import glass_tpu.ops.pallas_spmm as ps
from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import autotune as tauto
from glass_tpu_torch.ops import band_spmm as tb
from glass_tpu_torch.ops import bcsr_spmm as tbs
from glass_tpu_torch.ops import dense_q as tdq
from glass_tpu_torch.ops import graph as tgraph
from test_torch_band import CASES, layout_case
# both planners under the JAX planner's constants (autouse)
from test_torch_planner import jax_planner_constants  # noqa: F401

B = 128


# ------------------------------------------------------------ 3xTF32 band


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to
    the magnitude's bit pattern and clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(t: torch.Tensor):
    hi = tf32_rna(t)
    return hi, tf32_rna(t - hi)


def three_tf32_band(band, x: torch.Tensor) -> torch.Tensor:
    """The f32 band kernel's arithmetic in torch: each group's slab and x
    window (rows outside [0, n_x) zero) split into TF32 hi and lo, and
    a_hi x_hi + a_hi x_lo + a_lo x_hi summed in f64, rounded to f32."""
    x = tb.x_operand(band.slabs.dtype, x)
    n_x, h = x.shape
    k = band.w_blocks * B
    idx = band.clo.long()[:, None] * B + torch.arange(k)[None, :]
    inside = (idx >= 0) & (idx < n_x)
    xw = torch.where(inside[..., None], x[idx.clamp(0, n_x - 1)], 0.0)
    a_hi, a_lo = split(band.slabs.float())
    x_hi, x_lo = split(xw)
    out = (torch.bmm(a_hi.double(), x_hi.double())
           + torch.bmm(a_hi.double(), x_lo.double())
           + torch.bmm(a_lo.double(), x_hi.double()))
    return out.float().reshape(-1, h)[: band.n_node]


def clustered_edges(n_comm, csz=B, e=6000, intra_frac=0.95, seed=5):
    """``bench.py::clustered_graph``'s recipe at a small size."""
    rng = np.random.default_rng(seed)
    n = n_comm * csz
    intra = int(intra_frac * e)
    ci = rng.integers(0, n_comm, size=intra)
    src_i = ci * csz + rng.integers(0, csz, size=intra)
    dst_i = ci * csz + rng.integers(0, csz, size=intra)
    cx = rng.integers(0, n_comm - 1, size=e - intra)
    src_x = cx * csz + rng.integers(0, csz, size=e - intra)
    dst_x = (cx + 1) * csz + rng.integers(0, csz, size=e - intra)
    src = np.concatenate([src_i, src_x])
    dst = np.concatenate([dst_i, dst_x])
    return np.stack([np.r_[src, dst], np.r_[dst, src]]), n


def band_of(ei, w, n, aggr):
    g = tgraph.build_graph(ei, w, n, aggr, materialize_dense=False,
                           materialize_bcsr=True, sparse_layout="band",
                           device="cpu")
    assert g.band is not None and g.band.slabs.dtype == torch.float32
    return g.band


def wide_range_band(rng):
    """A band whose values span 2^-20 to 2^4 ("sum" keeps the weights)."""
    ei, n = clustered_edges(10, e=5000, seed=9)
    w = np.exp2(rng.uniform(-20, 4, ei.shape[1])).astype(np.float32)
    band = band_of(ei, w, n, "sum")
    nz = band.slabs[band.slabs != 0].abs()
    assert nz.min() < 2.0 ** -18 and nz.max() > 2.0 ** 2
    return band


def assert_3xtf32_close(band, x):
    emu = three_tf32_band(band, x)
    ref = tb.band_spmm_reference(band, x)
    assert emu.shape == ref.shape
    err = float((emu - ref).abs().max())
    assert err <= 1e-6 * float(ref.abs().max()), err


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    cases = {  # value -> TF32 value
        one + 2.0 ** -11: one + 2.0 ** -10,        # a tie: away from zero
        -(one + 2.0 ** -11): -(one + 2.0 ** -10),
        one + 3 * 2.0 ** -12: one + 2.0 ** -10,    # above half: up
        one + 2.0 ** -12: one,                     # below half: down
        one + 2.0 ** -10: one + 2.0 ** -10,        # already TF32
        2.0 ** -20 * 1.5: 2.0 ** -20 * 1.5,
        0.0: 0.0,
    }
    v = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(tf32_rna(v), want)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32)) * 1e3
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # hi + lo keeps about 21 bits
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -21


@pytest.mark.parametrize("h", [17, 64, 128])
@pytest.mark.parametrize("n_comm", [8, 12])
def test_3xtf32_matches_plain_on_clustered_bands(n_comm, h):
    ei, n = clustered_edges(n_comm)
    band = band_of(ei, None, n, "gcn")
    x = torch.from_numpy(np.random.default_rng(h).normal(
        size=(n, h)).astype(np.float32))
    assert_3xtf32_close(band, x)


@pytest.mark.parametrize("h", [17, 64])
def test_3xtf32_matches_plain_on_a_wide_range(rng, h):
    band = wide_range_band(rng)
    x = torch.from_numpy(rng.normal(size=(band.n_node, h)).astype(np.float32))
    assert_3xtf32_close(band, x)
    # bf16 x (widened exactly) takes the same path
    assert_3xtf32_close(band, x.to(torch.bfloat16))


@pytest.mark.parametrize("name", CASES)
def test_3xtf32_matches_plain_and_pallas_on_host_cases(rng, name):
    r, c, w, n, rps = layout_case(name, rng)
    fit = tb.affine_fit(r, c, w, n, rps) if name == "chain" else None
    t = tb.build_band(r, c, w, n, rps, affine=fit)
    x = rng.normal(size=(n, 17)).astype(np.float32)
    assert_3xtf32_close(t, torch.from_numpy(x))
    jb = pb.build_band(r, c, w, n, rps, affine=fit)
    ref = np.asarray(pb.band_spmm(jb, jnp.asarray(x), interpret=True))
    emu = three_tf32_band(t, torch.from_numpy(x)).numpy()
    assert np.abs(emu - ref).max() <= 1e-5 * np.abs(ref).max()


# ------------------------------------------------------ 3xTF32 BCSR


def three_tf32_bcsr(bcsr, x: torch.Tensor) -> torch.Tensor:
    """The f32 BCSR kernel's arithmetic in torch: for each row block, its
    live blocks [block_row_ptr, block_row_end) only, each block and its x
    rows (past n_x zero) split into TF32 hi and lo, a_hi x_hi + a_hi x_lo +
    a_lo x_hi summed in f64, rounded to f32."""
    x = tb.x_operand(bcsr.blocks.dtype, x)
    n_x, h = x.shape
    x_pad = x.new_zeros((bcsr.n_cb * B, h))
    x_pad[:n_x] = x
    ptr = bcsr.block_row_ptr.long()
    end = bcsr.block_row_end.long()
    counts = end - ptr[:-1]
    rows = torch.repeat_interleave(torch.arange(bcsr.n_rb), counts)
    live = torch.cat([torch.arange(int(a), int(e))
                      for a, e in zip(ptr[:-1], end)] + [torch.zeros(0, dtype=torch.long)])
    a = bcsr.blocks.view(-1, B, tbs.CHUNK, B)[live // tbs.CHUNK, :,
                                              live % tbs.CHUNK]
    xb = x_pad.view(bcsr.n_cb, B, h)[bcsr.block_col.long()[live]]
    a_hi, a_lo = split(a.float())
    x_hi, x_lo = split(xb)
    prod = (torch.bmm(a_hi.double(), x_hi.double())
            + torch.bmm(a_hi.double(), x_lo.double())
            + torch.bmm(a_lo.double(), x_hi.double()))
    out = torch.zeros((bcsr.n_rb, B, h), dtype=torch.float64)
    out.index_add_(0, rows, prod)
    return out.float().view(-1, h)[: bcsr.n_node]


def bcsr_layout(rng, name):
    """(JAX BCSR, port BCSR, n): "clustered" (bench.py::clustered_graph's
    recipe, gcn), "wide_row" (a row block of 10 column blocks, empty row
    blocks, n % 128 != 0, mean) or "wide_range" (values spanning 2^-20 to
    2^4, sum)."""
    if name == "wide_row":
        n = 10 * B + 21
        src = np.r_[rng.integers(0, B, 500), rng.integers(5 * B, n, 400)]
        dst = np.r_[rng.integers(0, n, 500), rng.integers(0, n, 400)]
        ei = np.stack([src, dst])
        w = tgraph.normalized_edge_weight(ei, np.ones(ei.shape[1]), n, "mean")
    else:
        ei, n = clustered_edges(10, e=5000, seed=9)
        if name == "wide_range":
            w = np.exp2(rng.uniform(-20, 4, ei.shape[1])).astype(np.float32)
        else:
            w = tgraph.normalized_edge_weight(ei, np.ones(ei.shape[1]), n,
                                              "gcn")
    jb = ps.build_bcsr(ei[0], ei[1], w, n)
    t = tbs.build_bcsr(ei[0], ei[1], w, n)
    assert t.live_blocks < t.nnz_blocks  # the walk skips padding
    if name == "wide_range":
        nz = t.blocks[t.blocks != 0].abs()
        assert nz.min() < 2.0 ** -18 and nz.max() > 2.0 ** 2
    return jb, t, n


@pytest.fixture(autouse=False)
def fresh_bcsr_cache():
    ps.bcsr_spmm.clear_cache()
    yield
    ps.bcsr_spmm.clear_cache()


@pytest.mark.parametrize("h", [8, 17, 64, 128])
@pytest.mark.parametrize("name", ["clustered", "wide_row", "wide_range"])
def test_3xtf32_bcsr_walk_matches_plain_and_pallas(rng, fresh_bcsr_cache,
                                                   name, h):
    jb, t, n = bcsr_layout(rng, name)
    x = rng.normal(size=(n, h)).astype(np.float32)
    emu = three_tf32_bcsr(t, torch.from_numpy(x))
    ref = tbs.bcsr_spmm_reference(t, torch.from_numpy(x))
    assert emu.shape == ref.shape == (n, h)
    assert float((emu - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    jax_out = np.asarray(ps.bcsr_spmm(jb, jnp.asarray(x), interpret=True))
    assert np.abs(emu.numpy() - jax_out).max() <= 1e-5 * np.abs(jax_out).max()
    # bf16 x is widened exactly and takes the same walk
    xb = torch.from_numpy(x).to(torch.bfloat16)
    emu_b = three_tf32_bcsr(t, xb)
    ref_b = tbs.bcsr_spmm_reference(t, xb)
    assert float((emu_b - ref_b).abs().max()) <= 1e-6 * float(ref_b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [8, 17, 64, 200])
def test_mma_x_operand_rounds_once_like_the_band(rng, h, dtype):
    """The bf16/int8 BCSR and band kernels' x: rounded to bf16 as
    band_spmm.x_operand rounds it for bf16 and int8 layouts, rows padded
    with zero columns to a multiple of 8 values, 16-byte aligned; bf16 x of
    such a width is used as it is."""
    x = torch.from_numpy(rng.normal(size=(300, h)).astype(np.float32)).to(dtype)
    xb, ld = tb.mma_x_operand(x)
    assert xb.dtype == torch.bfloat16 and xb.is_contiguous()
    assert ld % 8 == 0 and h <= ld < h + 8 and xb.shape == (300, ld)
    assert xb.data_ptr() % 16 == 0
    for layout_dtype in (torch.bfloat16, torch.int8):
        assert torch.equal(xb[:, :h].float(), tb.x_operand(layout_dtype, x))
    assert not xb[:, h:].any()
    if dtype == torch.bfloat16 and h % 8 == 0:
        assert xb.data_ptr() == x.data_ptr()


# ------------------------------------------------------ the int8 dense kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, h", [(700, 17), (1100, 64), (300, 200)])
def test_dense_x_operand_rounds_once_like_the_band(rng, n, h, dtype):
    x = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)).to(dtype)
    k_pad = -(-n // B) * B
    xt = tdq.x_operand(x, k_pad)
    assert xt.dtype == torch.bfloat16 and xt.shape == (h, k_pad)
    assert xt.is_contiguous()
    assert torch.equal(xt[:, :n].t().float(), tb.x_operand(torch.int8, x))
    assert not xt[:, n:].any()


def sparse_dense(rng, n, zero_row):
    """An (n, n) f32 adjacency about 2 % dense, row ``zero_row`` empty."""
    d = np.where(rng.random((n, n)) < 0.02,
                 rng.uniform(0.1, 1.0, (n, n)), 0.0).astype(np.float32)
    d[zero_row] = 0.0
    return d


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [17, 64, 200])
@pytest.mark.parametrize("n", [700, 1100])
def test_dense_q_matches_pallas_at_the_kernel_check_shapes(rng, n, h,
                                                           x_dtype):
    """chip_smoke.py's kernel_q_small shapes: n % 128 != 0, an all-zero
    row, H of one, one and four 64-column tiles."""
    d = sparse_dense(rng, n, zero_row=n // 3)
    jq, t = pd.build_dense_q(d), tdq.build_dense_q(d)
    assert not t.q[n // 3].any() and float(t.scale[n // 3]) == 1.0
    x = rng.normal(size=(n, h)).astype(np.float32)
    xj = jnp.asarray(x).astype(x_dtype)
    ref = np.asarray(pd.dense_q_spmm(jq, jq, xj, True))
    out = tdq.dense_q_spmm(t, None, torch.from_numpy(
        np.array(xj.astype(jnp.float32))).to(getattr(torch, x_dtype)))
    assert out.shape == (n, h) and out.dtype == torch.float32
    assert not out[n // 3].any()
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_int8_dense_candidate_priced_by_its_kernel(monkeypatch):
    """The planner prices dense_dtype "int8" by the int8 dense kernel's rate
    where the int8 layout's rule holds, and as the bf16 matrix that
    build_graph then builds where it does not."""
    monkeypatch.setattr(tgraph, "_DENSE_BYTE_TERM", False)
    for n, rate in ((14587, tgraph._DENSE_Q_FLOPS),
                    (60000, tgraph._MXU_FLOPS["bf16"])):
        assert tdq.dense_q_vmem_ok(n, n) == (n == 14587)
        cost = tgraph._dense_segment_costs(n, 1000, "int8")["dense"]
        assert cost == 2.0 * n * n * 128 / rate


def test_dense_kernel_is_a_source_of_its_own():
    assert "dense_q_spmm" in _build.SOURCES
    assert (_build.CSRC / "dense_q_spmm.cu").is_file()


# --------------------------------------------------- the calibration's key


@pytest.mark.parametrize("edited", ["band_spmm.cu", "bcsr_spmm.cu",
                                    "spmm_common.cuh"])
def test_autotune_path_follows_the_kernel_sources(tmp_path, monkeypatch,
                                                  edited):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = tauto.default_autotune_path("cuda")
    assert before == tauto.default_autotune_path("cuda")  # stable
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = tauto.default_autotune_path("cuda")
    assert after != before and after.parent == before.parent
    # the CPU fit times the plain versions: no key
    assert tauto.default_autotune_path("cpu").name == "autotune_cpu.json"


def test_autotune_path_ignores_other_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = tauto.default_autotune_path("cuda")
    with open(csrc / "graph_norm.cu", "a") as f:
        f.write("\n// edited\n")
    assert tauto.default_autotune_path("cuda") == before

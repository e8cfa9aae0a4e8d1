"""The port's BCSR SpMM against the JAX Pallas kernels.

``bcsr_spmm_reference`` (the CUDA kernel's plain PyTorch version, which the
wrapper runs for CPU tensors) is held against ``glass_tpu``'s ``bcsr_spmm``
in interpret mode, for both Pallas kernel bodies: ``_bcsr_chunk_kernel``
(x resident) and ``_bcsr_chunk_kernel_large`` (x streamed, forced by a
1-byte VMEM limit as in tests/test_pallas.py). The CUDA kernel itself is
held against the same plain version on the card by chip_smoke.py.
Tolerance: rtol 1e-5 and atol 1e-5 * max|x| (f32 sums in another order).

The kernel reads each row block's nonzero blocks only, up to the port's
skip table ``block_row_end``: per row block it counts exactly the stored
blocks that hold a nonzero value, at f32, bf16 and int8, while every array
the JAX builder returns stays equal to its output.
"""

import numpy as np
import pytest
import torch

import glass_tpu.ops.pallas_spmm as ps
from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import bcsr_spmm as tb
from glass_tpu_torch.ops import graph as tgraph
from test_torch_tensor_cores import clustered_edges


def layout_edges(name, rng):
    if name == "random":
        n = 300
        src, dst = rng.integers(0, n, 1200), rng.integers(0, n, 1200)
        return np.stack([np.r_[src, dst], np.r_[dst, src]]), n
    # row block 0 touches 10 column blocks (two chunks); row blocks 2 and 4
    # are empty; n % 128 != 0
    n = 10 * 128 + 21
    src = np.r_[rng.integers(0, 128, 500), rng.integers(5 * 128, n, 400)]
    dst = np.r_[rng.integers(0, n, 500), rng.integers(0, n, 400)]
    src = np.r_[src, src[:50]]
    dst = np.r_[dst, dst[:50]]
    return np.stack([src, dst]), n


def skip_case(name, rng):
    if name == "clustered":  # bench.py::clustered_graph's recipe, small
        return clustered_edges(10, e=6000, seed=int(rng.integers(1 << 30)))
    if name == "all_empty":
        return np.zeros((2, 0), np.int64), 300
    return layout_edges(name, rng)


def layouts(name, rng):
    ei, n = layout_edges(name, rng)
    w = tgraph.normalized_edge_weight(ei, np.ones(ei.shape[1]), n, "mean")
    jb = ps.build_bcsr(ei[0], ei[1], w, n)
    tbcsr = tb.build_bcsr(ei[0], ei[1], w, n)
    return jb, tbcsr, n


@pytest.fixture
def streamed(request, monkeypatch):
    """Selects the Pallas kernel body: False = x resident, True = streamed."""
    if request.param:
        monkeypatch.setattr(ps, "_X_VMEM_LIMIT_BYTES", 1)
    ps.bcsr_spmm.clear_cache()
    yield request.param
    ps.bcsr_spmm.clear_cache()


@pytest.mark.parametrize("streamed", [False, True], indirect=True,
                         ids=["resident", "streamed"])
@pytest.mark.parametrize("h", [8, 17, 64, 128])
@pytest.mark.parametrize("name", ["random", "wide_row_empty_rows"])
def test_reference_matches_pallas(rng, name, h, streamed):
    jb, tbcsr, n = layouts(name, rng)
    x = rng.normal(size=(n, h)).astype(np.float32)
    ref = np.asarray(ps.bcsr_spmm(jb, x, interpret=True))
    launches = tb.bcsr_spmm.launches
    out = tb.bcsr_spmm(tbcsr, torch.from_numpy(x))
    assert tb.bcsr_spmm.launches == launches  # CPU: plain version, no launch
    assert out.shape == (n, h) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(x).max())
    np.testing.assert_array_equal(
        out.numpy(), tb.bcsr_spmm_reference(tbcsr, torch.from_numpy(x)).numpy())


def test_empty_row_blocks_are_zero(rng):
    _, tbcsr, n = layouts("wide_row_empty_rows", rng)
    out = tb.bcsr_spmm(tbcsr, torch.randn(n, 5))
    assert not out[2 * 128: 3 * 128].any() and not out[4 * 128: 5 * 128].any()


def test_all_empty_graph():
    b = tb.build_bcsr(np.zeros(0, int), np.zeros(0, int), np.zeros(0), 200)
    out = tb.bcsr_spmm(b, torch.randn(200, 3))
    assert out.shape == (200, 3) and not out.any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.bfloat16, torch.int32])
def test_wrapper_refuses_non_f32(rng, dtype):
    """x of a type the kernel does not take is refused; bf16 x, which it
    takes since mixed precision, is widened exactly for f32 blocks."""
    _, tbcsr, n = layouts("random", rng)
    x = torch.randn(n, 4)
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(
            tb.bcsr_spmm(tbcsr, x.to(dtype)).numpy(),
            tb.bcsr_spmm(tbcsr, x.to(dtype).float()).numpy())
        return
    with pytest.raises(TypeError, match="float32"):
        tb.bcsr_spmm(tbcsr, x.to(dtype))


def test_wrapper_refuses_grad_strides_and_shapes(rng):
    _, tbcsr, n = layouts("random", rng)
    with pytest.raises(RuntimeError, match="autograd"):
        tb.bcsr_spmm(tbcsr, torch.zeros(n, 4, requires_grad=True))
    with pytest.raises(ValueError, match="contiguous"):
        tb.bcsr_spmm(tbcsr, torch.zeros(4, n).t())
    with pytest.raises(ValueError, match="rows"):
        tb.bcsr_spmm(tbcsr, torch.zeros(tbcsr.n_cb * 128 + 1, 4))
    with pytest.raises(ValueError, match=r"\(n, H\)"):
        tb.bcsr_spmm(tbcsr, torch.zeros(n))


def test_wrapper_refuses_other_devices(rng):
    _, tbcsr, n = layouts("random", rng)
    with pytest.raises(ValueError, match="one device"):
        tb.bcsr_spmm(tbcsr, torch.zeros(n, 4, device="meta"))


def test_cuda_entry_points_raise_without_card(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ei, n = layout_edges("random", rng)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgraph.build_graph(ei, None, n, "gcn", materialize_bcsr=True,
                           sparse_layout="bcsr")


def test_library_name_tracks_source():
    p = _build.library_path("bcsr_spmm")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libbcsr_spmm-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


SKIP_CASES = ["random", "wide_row_empty_rows", "clustered", "all_empty"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", SKIP_CASES)
def test_skip_table_counts_the_nonzero_blocks(rng, name, dtype):
    """block_row_end[rb] - block_row_ptr[rb] is the count of rb's stored
    blocks that hold a nonzero value; they come first in its run, and the
    padding after them is zeros."""
    ei, n = skip_case(name, rng)
    w = tgraph.normalized_edge_weight(ei, np.ones(ei.shape[1]), n, "gcn")
    t = tb.build_bcsr(ei[0], ei[1], w, n, dtype=dtype)
    ptr = t.block_row_ptr.numpy()
    end = t.block_row_end.numpy()
    assert t.block_row_end.dtype == torch.int32 and end.shape == (t.n_rb,)
    blocks = t.blocks.view(-1, 128, tb.CHUNK, 128).float()
    nonzero = (blocks != 0).any(dim=3).any(dim=1).reshape(-1).numpy()
    for rb in range(t.n_rb):
        run = nonzero[ptr[rb]: ptr[rb + 1]]
        assert end[rb] - ptr[rb] == run.sum(), rb
        assert run[: end[rb] - ptr[rb]].all() and not run[end[rb] - ptr[rb]:].any()
    assert t.live_blocks == nonzero.sum()
    if name == "all_empty":
        assert t.live_blocks == 0 and t.nnz_blocks == tb.CHUNK


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", SKIP_CASES)
def test_arrays_stay_the_jax_builders(rng, name, dtype):
    """Beside the skip table, every array equals
    ``glass_tpu.ops.pallas_spmm.build_bcsr_arrays``'s (blocks bit for bit
    where both round from the same f32 sums: bf16 and int8)."""
    ei, n = skip_case(name, rng)
    w = tgraph.normalized_edge_weight(ei, np.ones(ei.shape[1]), n, "gcn")
    if ei.shape[1] == 0:  # the JAX normalization fails without edges
        w = np.zeros(0, np.float32)
    ref = ps.build_bcsr_arrays(ei[0], ei[1], w, n, dtype)
    out = tb.build_bcsr_arrays(ei[0], ei[1], w, n, dtype)
    assert set(ref) <= set(out) and set(out) - set(ref) == {"block_row_end"}
    for key in ("block_col", "block_row_ptr", "chunk_start", "chunk_len",
                "chunk_row", "chunk_first", "chunk_last"):
        assert out[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    assert (out["n_rb"], out["n_cb"]) == (ref["n_rb"], ref["n_cb"])
    blocks = np.asarray(ref["blocks"])
    assert tuple(out["blocks"].shape) == blocks.shape
    if dtype == "float32":
        np.testing.assert_allclose(out["blocks"].numpy(), blocks, rtol=2e-7)
    else:
        np.testing.assert_array_equal(
            out["blocks"].view(torch.int8).numpy() if dtype == "int8"
            else out["blocks"].view(torch.int16).numpy(),
            blocks.view(np.int8) if dtype == "int8" else blocks.view(np.int16))

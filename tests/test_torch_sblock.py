"""The sparse-block layout (``ops/sblock_spmm.py``) and its SpMM.

On the CPU: the layout's integers (from row-sorted and from shuffled
edges: the same arrays; each block's run sorted by local row, then column;
the row offsets those of the local rows; the block tables those of the
edges' ``BlockPattern``), empty row blocks, blocks whose edges all weigh
0, n not a multiple of 128, duplicate edges; the plain version against
``bcsr_spmm_reference`` and the dense product within 1e-5 * max|plain| at
H = 17, 64 and 128; autograd's dx over a non-symmetric graph's transposed
layout; ``spmm``'s dispatch and ``build_graph``'s forced layout.

Marked ``card`` (they skip without one; on the card machine, which has no
JAX: ``python -m pytest --noconftest -m card tests/test_torch_sblock.py``):
the kernel against the plain version (bf16 x, blocks fuller than a stage
holds, empty row blocks, H past one column tile), bit-equal output over
two runs, a capture in a CUDA graph whose replay gives the eager result,
and a ``Trainer``'s captured steps over the layout, whose losses are
bit-equal over two runs (on the CPU the same epochs through the plain
version). This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from glass_tpu_torch import GLASS
from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import bcsr_spmm as tbs
from glass_tpu_torch.ops import graph as tgraph
from glass_tpu_torch.ops import sblock_spmm as tsb
from glass_tpu_torch.ops.spmm import spmm
from glass_tpu_torch.train import loop as tloop

B = 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def case_edges(name, seed=0):
    """(edge_index, weights, n) of a named case."""
    rng = np.random.default_rng(seed)
    if name == "random":
        n = 300
        ei = rng.integers(0, n, (2, 3000))
    elif name == "ragged":
        # n % 128 != 0; row blocks 2 and 4 hold no edge; row block 0's
        # edges reach every column block; duplicates
        n = 10 * B + 21
        src = np.r_[rng.integers(0, B, 900), rng.integers(5 * B, n, 700)]
        dst = rng.integers(0, n, src.shape[0])
        ei = np.stack([np.r_[src, src[:60]], np.r_[dst, dst[:60]]])
    elif name == "zero_block":
        # block (0, 1) holds edges of weight 0 only: it is not stored
        n = 3 * B
        src = np.r_[rng.integers(0, B, 200), rng.integers(0, n, 400)]
        dst = np.r_[rng.integers(B, 2 * B, 200), rng.integers(0, n, 400)]
        keep = ~((src < B) & (dst >= B) & (dst < 2 * B))
        keep[:200] = True
        ei = np.stack([src[keep], dst[keep]])
        w = rng.normal(size=ei.shape[1]).astype(np.float32)
        w[:200] = 0.0
        return ei, w, n
    elif name == "dense_block":
        # a full block past a stage's MCAP nonzeros beside sparse ones
        n = 3 * B
        r, c = np.meshgrid(np.arange(B, 2 * B), np.arange(B, 2 * B),
                           indexing="ij")
        extra = rng.integers(0, n, (2, 500))
        ei = np.concatenate([np.stack([r.ravel(), c.ravel()]), extra], 1)
    else:
        raise KeyError(name)
    w = rng.normal(size=ei.shape[1]).astype(np.float32)
    return ei, w, n


CASES = ("random", "ragged", "zero_block", "dense_block")


def dense_of(ei, w, n):
    d = np.zeros((n, n))
    np.add.at(d, (ei[0], ei[1]), w.astype(np.float64))
    return torch.from_numpy(d.astype(np.float32))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_layout_integers(name, order):
    ei, w, n = case_edges(name)
    if order == "sorted":
        o = np.lexsort((ei[1], ei[0]))
    else:
        o = np.random.default_rng(1).permutation(ei.shape[1])
    a = tsb.build_sblock_arrays(ei[0][o], ei[1][o], w[o], n)
    ref = tsb.build_sblock_arrays(*sorted_args(ei, w), n)
    for k, v in ref.items():
        np.testing.assert_array_equal(a[k], v, err_msg=k)
    # the block tables are the nonzero edges' block pattern
    keep = w != 0
    pat = tbs.block_pattern(ei[0][keep], ei[1][keep], None, a["n_rb"],
                            a["n_cb"])
    np.testing.assert_array_equal(a["block_row_ptr"], pat.ptr)
    np.testing.assert_array_equal(a["block_col"], pat.cb)
    nz = a["nz_ptr"]
    assert nz[0] == 0 and nz[-1] == a["val"].shape[0]
    assert (np.diff(nz) > 0).all()
    uniq = np.unique(np.stack([ei[0][keep], ei[1][keep]]), axis=1)
    assert nz[-1] == uniq.shape[1]  # duplicates add up into one nonzero
    for b in range(a["block_col"].shape[0]):
        rows = a["row"][nz[b]:nz[b + 1]].astype(np.int64)
        cols = a["col"][nz[b]:nz[b + 1]].astype(np.int64)
        key = rows * B + cols
        assert (np.diff(key) > 0).all()  # by row, then column, distinct
        off = a["row_off"][b].astype(np.int64)
        np.testing.assert_array_equal(
            off[:B + 1], np.searchsorted(rows, np.arange(B + 1)))
        assert (off[B + 1:] == off[B]).all()
    check_stages(a)


def check_stages(a):
    """The stage table covers each row block's nonzeros in order, in runs
    of at most STAGE_NNZ within one block, each with its block's column
    block and its offset in the block."""
    nz, bp, st, sp = (a[k].astype(np.int64) for k in
                      ("nz_ptr", "block_row_ptr", "stages", "stage_ptr"))
    assert sp[0] == 0 and sp[-1] == st.shape[0]
    for rb in range(a["n_rb"]):
        run = st[sp[rb]:sp[rb + 1]]
        count, off = run[:, 3] & 0xFFFF, run[:, 3] >> 16
        assert (count > 0).all() and (count <= tsb.STAGE_NNZ).all()
        ends = run[:, 0] + count
        np.testing.assert_array_equal(run[1:, 0], ends[:-1])
        if run.shape[0]:
            assert run[0, 0] == nz[bp[rb]] and ends[-1] == nz[bp[rb + 1]]
        assert ((run[:, 1] >= bp[rb]) & (run[:, 1] < bp[rb + 1])).all()
        np.testing.assert_array_equal(run[:, 2], a["block_col"][run[:, 1]])
        np.testing.assert_array_equal(off, run[:, 0] - nz[run[:, 1]])
        assert (run[:, 0] + count <= nz[run[:, 1] + 1]).all()


def test_stage_size_is_the_kernels():
    src = (_build.CSRC / "sblock_spmm.cu").read_text()
    assert f"constexpr int MCAP = {tsb.STAGE_NNZ};" in src
    assert f"constexpr int ROW_LD = {tsb.ROW_LD};" in src
    ei, w, n = case_edges("dense_block")
    a = tsb.build_sblock_arrays(*sorted_args(ei, w), n)
    # the full block takes ceil(16384 / STAGE_NNZ) stages
    assert a["stages"].shape[0] == a["block_col"].shape[0] - 1 + \
        -(-B * B // tsb.STAGE_NNZ)
    # the kernel copies a stage's values and columns in whole 16-byte
    # pieces: build_sblock pads their storage to one
    for nnz in (1, 3, 4, 17):
        sb = tsb.build_sblock(np.zeros(nnz, np.int64), np.arange(nnz),
                              np.ones(nnz, np.float32), 300)
        assert sb.nnz == nnz and sb.val.is_contiguous()
        assert tsb._whole_pieces(sb.val) and tsb._whole_pieces(sb.col)
    assert not tsb._whole_pieces(torch.zeros(3))  # 12 bytes
    assert tsb._whole_pieces(torch.zeros(4))


def sorted_args(ei, w):
    o = np.lexsort((ei[1], ei[0]))
    return ei[0][o], ei[1][o], w[o]


def test_all_empty_layout():
    sb = tsb.build_sblock(np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0, np.float32), 300)
    assert sb.live_blocks == 0 and sb.nnz == 0
    assert sb.block_row_ptr.tolist() == [0, 0, 0, 0]
    out = tsb.sblock_spmm(sb, torch.randn(300, 5))
    assert out.shape == (300, 5) and not out.any()


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("h", [17, 64, 128])
def test_plain_matches_bcsr_and_dense(name, h):
    ei, w, n = case_edges(name)
    sb = tsb.build_sblock(*sorted_args(ei, w), n)
    bc = tbs.build_bcsr(ei[0], ei[1], w, n)
    x = torch.randn(n, h, generator=torch.Generator().manual_seed(h))
    got = tsb.sblock_spmm(sb, x)
    tol = 1e-5 * float(got.abs().max())
    assert got.shape == (n, h) and got.dtype == torch.float32
    torch.testing.assert_close(got, tbs.bcsr_spmm_reference(bc, x),
                               rtol=0, atol=tol)
    torch.testing.assert_close(got, dense_of(ei, w, n) @ x, rtol=0, atol=tol)


def test_bf16_x_is_widened_exactly():
    ei, w, n = case_edges("random")
    sb = tsb.build_sblock(*sorted_args(ei, w), n)
    x = torch.randn(n, 64).to(torch.bfloat16)
    torch.testing.assert_close(tsb.sblock_spmm(sb, x),
                               tsb.sblock_spmm(sb, x.float()), rtol=0, atol=0)


def test_dx_through_the_transposed_layout():
    """A 'mean'-normalized graph is not symmetric: dx = A^T g runs over
    the layout of A^T, in x's dtype."""
    ei, _, n = case_edges("ragged")
    g = tgraph.build_graph(ei, None, n, "mean", materialize_dense=False,
                           materialize_bcsr=True, sparse_layout="sblock",
                           device="cpu")
    assert g.sblock is not None and g.sblock_t is not g.sblock
    assert g.plan is None and g.bcsr is None and g.band is None
    d = dense_of(np.stack([g.row.numpy(), g.col.numpy()]), g.weight.numpy(),
                 n)
    x = torch.randn(n, 24, requires_grad=True)
    gy = torch.randn(n, 24)
    y = spmm(g, x, "pallas")
    (dx,) = torch.autograd.grad(y, x, gy)
    tol = 1e-5 * float(y.detach().abs().max())
    torch.testing.assert_close(y, d @ x.detach(), rtol=0, atol=tol)
    torch.testing.assert_close(dx, d.T @ gy, rtol=0,
                               atol=1e-5 * float(dx.abs().max()))
    assert dx.dtype == x.dtype
    with pytest.raises(RuntimeError, match="transposed layout"):
        tsb.sblock_spmm(g.sblock, x)


def test_forced_layout_and_dispatch():
    ei, _, n = case_edges("random")
    ei = np.concatenate([ei, ei[::-1]], 1)
    g = tgraph.build_graph(ei, None, n, "gcn", materialize_dense=False,
                           materialize_bcsr=True, sparse_layout="sblock",
                           device="cpu")
    assert g.sblock_t is g.sblock  # a symmetric graph: one layout
    x = torch.randn(n, 8)
    before = tsb.sblock_spmm.launches
    torch.testing.assert_close(spmm(g, x, "pallas"),
                               tsb.sblock_spmm(g.sblock, x))
    torch.testing.assert_close(spmm(g, x, "pallas"), spmm(g, x, "segment"),
                               rtol=0, atol=1e-5 * float(x.abs().max()))
    assert tsb.sblock_spmm.launches == before  # the CPU launches no kernel
    with pytest.raises(ValueError, match="f32"):
        tgraph.build_graph(ei, None, n, "gcn", materialize_bcsr=True,
                           sparse_layout="sblock", dense_dtype="bf16",
                           device="cpu")


def test_kernel_source_is_built():
    assert "sblock_spmm" in _build.SOURCES
    assert (_build.CSRC / "sblock_spmm.cu").is_file()


# ------------------------------------------------------------------ card


def card_layout(name, device):
    ei, w, n = case_edges(name)
    return tsb.build_sblock(*sorted_args(ei, w), n, device=device), n


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("h,dtype", [(17, torch.float32), (64, torch.float32),
                                     (64, torch.bfloat16),
                                     (130, torch.float32)])
def test_kernel_matches_plain(card, name, h, dtype):
    sb, n = card_layout(name, card)
    x = torch.randn(n, h, generator=torch.Generator().manual_seed(7)).to(
        card, dtype)
    before = tsb.sblock_spmm.launches
    got = tsb.sblock_spmm(sb, x)
    torch.cuda.synchronize()
    assert tsb.sblock_spmm.launches == before + 1
    want = tsb.sblock_spmm_reference(sb, x)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.card
def test_kernel_is_bit_reproducible_and_capturable(card):
    sb, n = card_layout("dense_block", card)
    x = torch.randn(n, 64, generator=torch.Generator().manual_seed(3)).to(card)
    first = tsb.sblock_spmm(sb, x)
    second = tsb.sblock_spmm(sb, x)
    assert torch.equal(first, second)
    static_x = x.clone()
    tsb.sblock_spmm(sb, static_x)  # built and warm outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = tsb.sblock_spmm(sb, static_x)
    x2 = torch.randn(n, 64, generator=torch.Generator().manual_seed(4)).to(card)
    static_x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static_out, tsb.sblock_spmm(sb, x2))


def train_losses(device, seed=11):
    """Two epochs of a ``Trainer`` (dropout on) over a directed graph in
    the sparse-block layout ('mean': A^T is a layout of its own): the
    per-step losses."""
    rng = np.random.default_rng(seed)
    n = 3 * B + 40
    src = rng.integers(0, n, 4000)
    dst = rng.integers(0, n, 4000)
    g = tgraph.build_graph(np.stack([src, dst]), None, n, "mean",
                           materialize_dense=False, materialize_bcsr=True,
                           sparse_layout="sblock", device=device)
    assert g.sblock is not None and g.sblock_t is not g.sblock
    x = torch.from_numpy(rng.integers(0, 7, (n, 1))).to(device)
    pos = np.full((24, 10), -1, np.int64)
    for i in range(24):
        k = int(rng.integers(2, 11))
        pos[i, :k] = rng.choice(n, k, replace=False)
    y = (np.count_nonzero(pos >= 0, axis=1) > 5).astype(np.float32)
    model = GLASS(6, 32, 2, (1,), ("size",), dropout=0.5, activation="elu",
                  z_ratio=0.75, jk=True, spmm_mode="pallas", seed=seed,
                  device=device)
    trainer = tloop.Trainer(model, g, x,
                            tloop.TrainConfig(lr=1e-3, batch_size=6,
                                              loss="bce"))
    trainer.init(seed)
    out = []
    for epoch in range(2):
        pos_b, y_b = tloop.make_train_batches(
            np.random.default_rng(epoch), pos, y, 6)
        out.append(trainer.train_epoch(pos_b, y_b).step_losses)
    return np.concatenate(out)


def test_training_over_the_layout_repeats_on_the_cpu():
    a, b = train_losses("cpu"), train_losses("cpu")
    assert np.isfinite(a).all() and np.array_equal(a, b)


@pytest.mark.card
def test_training_losses_are_bit_reproducible(card):
    before = tsb.sblock_spmm.launches
    a = train_losses(card)
    assert tsb.sblock_spmm.launches > before  # the kernel ran
    b = train_losses(card)
    assert np.isfinite(a).all() and np.array_equal(a, b)

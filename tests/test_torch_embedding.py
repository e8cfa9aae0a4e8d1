"""The fixed-order embedding backward (glass_tpu_torch/ops/embedding.py) on
the CPU, where it runs its plain version: the same two levels the CUDA
kernel (csrc/embedding_bwd.cu) runs, the same additions in the same order.
chip_smoke.py holds the kernel against this plain version on the card.

Tolerances: the table's gradient within 1e-6 x max |grad| of the exact
(f64) sum. Against ``nn.Embedding``'s gradient, within 1e-6 x max plus
``nn.Embedding``'s own distance from the exact sum: its CPU backward adds
each id's rows one after the other, and over 6,250 rows an id (16 ids x
100k rows) that alone is 2.8e-6 x max off. bf16 cotangents are summed in
f32 (within 1e-6 of exact) and held within 1e-2 relative of
``nn.Embedding``'s gradient of the same bf16 values taken in f32 (with a
bf16 table it sums in bf16, 17 % of max off at 6,250 rows an id).
"""

import gc

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from glass_tpu_torch import GLASS
from glass_tpu_torch.nn.pretrain import EdgeGNN
from glass_tpu_torch.ops import embedding as E
from glass_tpu_torch.utils import checkpoint as tckpt

TOL = 1e-6
BF16_RTOL = 1e-2


def em_user_ids(rng):
    """57,344 degree-like ids: about 100 values, each on hundreds of rows
    (the stand-in's degrees are about 157 +- 12)."""
    return rng.poisson(157, 57_344).clip(0, 299), 300


CASES = {
    "em_user": em_user_ids,
    "ladder_16_ids": lambda rng: (rng.integers(0, 16, 100_000), 16),
    "ids_without_rows": lambda rng: (np.concatenate(
        [rng.integers(0, 20, 700), rng.integers(35, 41, 300)]), 50),
    "single_id": lambda rng: (np.zeros(777, np.int64), 1),
    "unique_ids": lambda rng: (rng.permutation(3000), 3000),
    "fewer_rows_than_a_chunk": lambda rng: (rng.integers(0, 5, 37), 9),
}


def case(name, h=64, seed=0):
    rng = np.random.default_rng(seed)
    ids, n_ids = CASES[name](rng)
    g = rng.standard_normal((ids.shape[0], h)).astype(np.float32)
    return torch.from_numpy(ids.astype(np.int64)), n_ids, torch.from_numpy(g)


def exact(ids, n_ids, g) -> torch.Tensor:
    return torch.zeros(n_ids, g.shape[1], dtype=torch.float64).index_add_(
        0, ids, g.double())


def nn_grad(ids, n_ids, g, dtype=torch.float32) -> torch.Tensor:
    w = torch.zeros(n_ids, g.shape[1], dtype=dtype, requires_grad=True)
    F.embedding(ids, w).backward(g.to(dtype))
    return w.grad


@pytest.mark.parametrize("name", sorted(CASES))
def test_fixed_order_gradient_matches_nn_embedding(name):
    ids, n_ids, g = case(name)
    w = torch.randn(n_ids, g.shape[1], requires_grad=True)
    E.embedding(w, ids).backward(g)
    ref = exact(ids, n_ids, g)
    scale = float(ref.abs().max())
    err = float((w.grad.double() - ref).abs().max())
    assert err <= TOL * scale, (err, scale)
    theirs = nn_grad(ids, n_ids, g)
    own = float((theirs.double() - ref).abs().max())
    assert float((w.grad - theirs).abs().max()) <= TOL * scale + own
    if name == "ids_without_rows":
        empty = torch.ones(n_ids, dtype=torch.bool)
        empty[ids] = False
        assert empty.sum() == 24 and not w.grad[empty].any()


@pytest.mark.parametrize("name", ["em_user", "ladder_16_ids"])
def test_bf16_cotangents_sum_in_f32(name):
    ids, n_ids, g = case(name)
    gb = g.to(torch.bfloat16)
    order = E.embedding_order(ids, n_ids)
    got = E.embedding_backward(order, gb)
    assert got.dtype == torch.float32
    ref = exact(ids, n_ids, gb.float())
    scale = float(ref.abs().max())
    assert float((got.double() - ref).abs().max()) <= TOL * scale
    theirs = nn_grad(ids, n_ids, gb.float())
    assert float((got - theirs).abs().max()) <= BF16_RTOL * scale


@pytest.mark.parametrize("name", ["em_user", "ladder_16_ids", "unique_ids"])
def test_two_runs_are_bit_equal(name):
    ids, n_ids, g = case(name)
    grads = []
    for _ in range(2):
        w = torch.ones(n_ids, g.shape[1], requires_grad=True)
        E.embedding(w, ids).backward(g)
        grads.append(w.grad)
    assert torch.equal(grads[0], grads[1])
    order = E.embedding_order(ids, n_ids)
    assert torch.equal(E.embedding_backward(order, g), grads[0])


@pytest.mark.parametrize("shape", [(1000,), (250, 4)])
def test_forward_is_index_select(shape):
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 40, shape))
    w = torch.randn(40, 8, requires_grad=True)
    out = E.embedding(w, ids)
    assert out.shape == shape + (8,)
    assert torch.equal(out, w.detach().index_select(0, ids.reshape(-1))
                       .view(*shape, 8))
    assert torch.equal(out, F.embedding(ids, w))


def test_order_is_the_ids_alone():
    """A stable argsort, each id's offset, the chunk split at CHUNK rows
    and a partial per (chunk, run), numbered in sorted order."""
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 7, 1000)
    ids[ids == 3] = 2  # an id with no rows
    o = E.embedding_order(torch.from_numpy(ids), 7)
    perm = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(o.perm.numpy(), perm)
    np.testing.assert_array_equal(o.sorted_ids.numpy(), ids[perm])
    np.testing.assert_array_equal(
        o.offsets.numpy(), np.concatenate([[0], np.cumsum(np.bincount(
            ids, minlength=7))]))
    assert o.n_chunks == 4 == -(-1000 // E.CHUNK)
    s = ids[perm]
    starts = np.r_[True, s[1:] != s[:-1]]
    starts[::E.CHUNK] = True
    slot = np.cumsum(starts) - 1
    assert o.n_partials == starts.sum()
    np.testing.assert_array_equal(o.part_start.numpy(),
                                  np.r_[slot[::E.CHUNK], o.n_partials])
    pid = s[starts]
    np.testing.assert_array_equal(
        o.id_part.numpy(), np.searchsorted(pid, np.arange(8)))
    assert o.id_part[3] == o.id_part[4]  # no partials for id 3
    again = E.embedding_order(torch.from_numpy(ids.copy()), 7)
    for f in ("perm", "sorted_ids", "part_start", "id_part"):
        assert torch.equal(getattr(o, f), getattr(again, f))


def test_order_rejects_ids_out_of_range():
    with pytest.raises(ValueError, match="ids must lie"):
        E.embedding_order(torch.tensor([0, 5]), 5)
    with pytest.raises(ValueError, match="integers"):
        E.embedding_order(torch.tensor([0.0]), 5)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        E.embedding_backward(E.embedding_order(torch.tensor([1]), 2),
                             torch.ones(1, 3, dtype=torch.float64))


def test_order_is_cached_per_id_tensor():
    """One order per tensor (each column view its own), reused, rebuilt
    after an in-place write, dropped with the tensor; none without a
    gradient to take."""
    gc.collect()  # orders of earlier tests' id tensors that are unreachable
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 9, (300, 2)))
    a = E.cached_order(x[:, 0], 9)
    assert E.cached_order(x[:, 0], 9) is a  # a new view of the same column
    b = E.cached_order(x[:, 1], 9)
    assert b is not a
    assert torch.equal(b.sorted_ids, torch.sort(x[:, 1]).values.int())
    x[0, 0] = 8  # written in place: the order is stale
    c = E.cached_order(x[:, 0], 9)
    assert c is not a and int(c.sorted_ids[-1]) == 8
    w = torch.randn(9, 4)
    before = len(E._ORDERS)
    E.embedding(w, torch.zeros(5, dtype=torch.int64))  # no gradient
    with torch.no_grad():
        E.embedding(w.requires_grad_(True), torch.zeros(6, dtype=torch.int64))
    assert len(E._ORDERS) == before
    del x, a, b, c
    gc.collect()
    assert len(E._ORDERS) == before - 2


def test_trunks_keep_their_embedding_module_and_checkpoints():
    """The tables stay ``nn.Embedding`` parameters named
    ``conv.input_emb.weight``: params_to_flax, params_from_flax and the
    checkpoint files are unchanged."""
    for make in (lambda s: GLASS(6, 16, 2, (3,), ("mean",), seed=s,
                                 device="cpu"),
                 lambda s: EdgeGNN(6, 16, 2, seed=s, device="cpu")):
        model = make(3)
        assert isinstance(model.conv.input_emb, torch.nn.Embedding)
        assert "conv.input_emb.weight" in model.state_dict()
        flat = tckpt.params_to_flax(model)
        assert flat["/params/conv/input_emb/embedding"].shape == (7, 16)
        other = tckpt.params_from_flax(make(4), flat)
        for k, v in model.state_dict().items():
            assert torch.equal(v, other.state_dict()[k]), k


def test_checkpoint_round_trip_after_a_step(tmp_path):
    """A trained table (its gradient from the fixed-order backward) saved
    and loaded bit for bit."""
    from glass_tpu_torch import build_graph
    rng = np.random.default_rng(6)
    ei = rng.integers(0, 200, (2, 1500))
    graph = build_graph(ei, None, 200, "mean", device="cpu")
    model = GLASS(6, 8, 1, (1,), ("size",), seed=1, device="cpu")
    x = torch.from_numpy(rng.integers(0, 7, (200, 1)))
    pos = torch.from_numpy(rng.integers(0, 200, (4, 5)))
    out = model(graph, x, pos, training=True,
                generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    grad = model.conv.input_emb.weight.grad
    assert grad is not None and grad.abs().max() > 0
    tckpt.save_checkpoint(tmp_path / "m", model)
    loaded = tckpt.params_from_flax(
        GLASS(6, 8, 1, (1,), ("size",), seed=2, device="cpu"),
        tckpt.load_checkpoint(tmp_path / "m.npz"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, loaded.state_dict()[k]), k


def test_edge_gnn_step_over_repeated_ids_is_bit_reproducible():
    """EdgeGNN over degree-like ids (repeats): two backward passes give
    the same gradient bits."""
    from glass_tpu_torch import build_graph
    rng = np.random.default_rng(7)
    ei = rng.integers(0, 500, (2, 4000))
    graph = build_graph(ei, None, 500, "gcn", device="cpu")
    x = torch.from_numpy(rng.integers(0, 12, (500, 1)))
    pos = torch.from_numpy(rng.integers(0, 500, (64, 2)))
    model = EdgeGNN(11, 16, 2, seed=0, device="cpu")
    grads = []
    for _ in range(2):
        model.zero_grad()
        model(graph, x, pos).sum().backward()
        grads.append(model.conv.input_emb.weight.grad.clone())
    assert torch.equal(grads[0], grads[1]) and grads[0].abs().max() > 0

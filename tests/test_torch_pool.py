"""The pool's gather (``ops/segment.py::pool_subgraphs``) against the form
in which every padding slot gathered row 0, kept here as
:func:`pool_row0`: values and gradients bit-equal, on a ppi_bp-shaped
batch (80 x 123 slots, about 9 % of them nodes, over 17,080 rows), and
bit-equal over two runs. The CPU case runs everywhere, its sums in a fixed
order (:func:`summed_in_order`); the card's is marked ``card`` (it skips
without one; on the card machine, which has no JAX: ``python -m pytest
--noconftest -m card tests/test_torch_pool.py``) and runs the gather's
backward as training does. ``tests/test_torch_ops.py`` holds the four pool
kinds in f32 and bf16 against :func:`pool_row0` at smaller sizes. This
file imports no JAX.
"""

import contextlib

import numpy as np
import pytest
import torch

from glass_tpu_torch.ops import segment as tseg

# ppi_bp's training batch (benchmark/configs/ppi_bp.json): 80 subgraphs
# padded to 123 slots, a mean of 10.2 nodes, over 17,080 rows
PPI_N, PPI_B, PPI_L, PPI_F = 17_080, 80, 123, 64


def pool_row0(emb: torch.Tensor, pos: torch.Tensor, kind: str) -> torch.Tensor:
    """``pool_subgraphs`` as it was before padding slots gathered rows of
    their own: every padding slot gathers row 0."""
    mask = pos >= 0
    g = emb[torch.where(mask, pos, 0).long()]
    m = mask[..., None].to(emb.dtype)
    if kind == "sum":
        return (g * m).sum(dim=1)
    if kind == "mean":
        return (g * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    if kind == "max":
        out = torch.where(mask[..., None], g, float("-inf")).amax(dim=1)
        return torch.where(mask.any(dim=1, keepdim=True), out, 0.0)
    if kind == "size":
        return (g * m).sum(dim=1) / torch.sqrt(
            torch.clamp(m.sum(dim=1), min=1.0))
    raise ValueError(kind)


@contextlib.contextmanager
def summed_in_order(device):
    """On the CPU, PyTorch's deterministic algorithms inside the block: the
    CPU's gather backward otherwise adds an index's slots from several
    threads at once, in an order that changes from run to run, whatever
    the padding. The card's backward sorts the indices and sums each
    index's slots in order either way, so it runs as training runs it."""
    if device.type != "cpu":
        yield
        return
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def padded_batch(rng, n, b, width, mean=None, empty=(0, 5)):
    """(b, width) int64 node matrix padded with -1: each row distinct
    nodes, nodes repeated across rows, the rows ``empty`` all padding;
    sizes 1..width, or a geometric draw of mean ``mean``."""
    pos = np.full((b, width), -1, np.int64)
    for i in range(b):
        if i in empty:
            continue
        k = (int(rng.integers(1, width + 1)) if mean is None
             else int(min(width, max(2, rng.geometric(1 / mean)))))
        pos[i, :k] = rng.choice(n, k, replace=False)
    return pos


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (a zero's sign included)."""
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(ints), b.view(ints)))


def pool_and_grad(fn, emb, pos, kind, dy):
    """``fn``'s pool of ``emb`` and the gradient of <pool, dy> in emb."""
    leaf = emb.detach().clone().requires_grad_(True)
    out = fn(leaf, pos, kind)
    (grad,) = torch.autograd.grad(out, leaf, dy)
    return out.detach(), grad


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device(request.param)


@pytest.mark.parametrize("kind", tseg.POOL_KINDS)
def test_ppi_bp_batch_bit_equal_to_row0(device, kind):
    rng = np.random.default_rng(24)
    pos = padded_batch(rng, PPI_N, PPI_B, PPI_L, mean=10.2)
    pos[1, :PPI_L] = rng.choice(PPI_N, PPI_L, replace=False)  # the width
    assert 0.05 < (pos >= 0).mean() < 0.15
    pos = torch.from_numpy(pos).to(device)
    gen = torch.Generator().manual_seed(5)
    emb = torch.randn(PPI_N, PPI_F, generator=gen).to(device)
    dy = torch.randn(PPI_B, PPI_F, generator=gen).to(device)
    with summed_in_order(device):
        out, grad = pool_and_grad(tseg.pool_subgraphs, emb, pos, kind, dy)
        want, want_grad = pool_and_grad(pool_row0, emb, pos, kind, dy)
        again, again_grad = pool_and_grad(tseg.pool_subgraphs, emb, pos,
                                          kind, dy)
    assert bit_equal(out, want) and bit_equal(grad, want_grad)
    assert bit_equal(out, again) and bit_equal(grad, again_grad)
    unused = torch.ones(PPI_N, dtype=torch.bool, device=device)
    unused[pos[pos >= 0]] = False
    assert not out[0].any() and not grad[unused].any()

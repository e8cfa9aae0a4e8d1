"""``GLASS_TPU_REMAT`` in the port (``glass_tpu_torch/nn/modules.py``), on
the CPU.

Under the switch each GLASSConv body runs again in the backward pass
(``torch.utils.checkpoint``, non-reentrant) instead of keeping its
intermediates, the counterpart of ``nn.remat`` in
``glass_tpu/nn/modules.py:268-276``. The conv's dropout mask is drawn once,
before the checkpointed body, from the generator's place in its sequence
without remat, so that, as ``tests/test_models.py:283`` holds the JAX
switch, a Trainer epoch with dropout 0.5 gives the same losses and
parameters, bit for bit, on and off: on the dense, segment, band and BCSR
layouts (their plain versions here) and with the fused norm's plain
version. The port's remat run is held against JAX's remat run with
dropout 0 as ``tests/test_torch_train.py`` holds the Trainers (losses
within rtol 1e-4, parameters within 3 * lr); and on a 1 x 2 mesh of gloo
ranks, where each rank keeps its node block's rows of the whole graph's
mask (``rows``), remat on and off give the same losses.
"""

import numpy as np
import pytest
import torch

from glass_tpu_torch import GLASS, build_graph
from glass_tpu_torch.nn import modules
from glass_tpu_torch.nn.dropout import Dropout
from glass_tpu_torch.train import loop as tloop

from chip_smoke import spawn
from test_torch_train import LR, run_both_trainers, trainer_inputs

import torch_ranks as R

N, E, BATCH = 384, 3000, 4
LAYOUTS = {
    "dense": (dict(materialize_dense=True), "dense"),
    "segment": (dict(materialize_dense=False), "segment"),
    "band": (dict(materialize_dense=False, materialize_bcsr=True,
                  sparse_layout="band"), "pallas"),
    "bcsr": (dict(materialize_dense=False, materialize_bcsr=True,
                  sparse_layout="bcsr"), "pallas"),
}


def remat_problem(seed=0):
    """tests/test_models.py:283's problem: a random 384-node graph, feature
    ids below 8, one batch of 4 subgraphs of 8 nodes, 2 classes."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
    x = rng.integers(0, 8, size=(N, 1))
    pos = np.stack([rng.choice(N, 8, replace=False) for _ in range(BATCH)])
    y = rng.integers(0, 2, BATCH)
    return ei, x, pos, y


def remat_epoch(monkeypatch, remat: str, layout: str, steps: int = 2):
    """One Trainer epoch of ``steps`` steps (dropout 0.5, 2 conv layers)
    with GLASS_TPU_REMAT=``remat``: (the step losses, the state dict, the
    GLASSConv forwards it ran)."""
    monkeypatch.setenv("GLASS_TPU_REMAT", remat)
    ei, x, pos, y = remat_problem()
    kw, mode = LAYOUTS[layout]
    g = build_graph(ei, None, N, "gcn", device="cpu", **kw)
    model = GLASS(8, 16, 2, (2,), ("size",), dropout=0.5, activation="elu",
                  z_ratio=0.75, jk=True, spmm_mode=mode, seed=1, device="cpu")
    trainer = tloop.Trainer(model, g, torch.from_numpy(x), tloop.TrainConfig(
        lr=1e-3, batch_size=BATCH, loss="ce", use_z=True))
    trainer.init(0)
    forwards = []
    real = modules.GLASSConv.forward

    def forward(conv, *a, **k):
        forwards.append(conv)
        return real(conv, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(modules.GLASSConv, "forward", forward)
        res = trainer.train_epoch(np.stack([pos] * steps),
                                  np.stack([y] * steps))
    return res.step_losses, model.state_dict(), len(forwards)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_norm"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_remat_is_bit_identical(monkeypatch, layout, fused):
    monkeypatch.setenv("GLASS_TPU_FUSED_NORM", "1" if fused else "0")
    off, p_off, fwd_off = remat_epoch(monkeypatch, "0", layout)
    on, p_on, fwd_on = remat_epoch(monkeypatch, "1", layout)
    np.testing.assert_array_equal(on, off)
    assert np.isfinite(on).all() and on[1] != on[0]
    for k, v in p_off.items():
        assert torch.equal(p_on[k], v), k
    # each conv body runs again in the backward pass: 2 layers x 2 steps
    assert (fwd_off, fwd_on) == (4, 8)


def test_remat_is_off_without_the_switch_and_outside_autograd(monkeypatch):
    """GLASS_TPU_REMAT unset runs no checkpoint; an eval forward (no
    gradients) runs none under the switch either, and draws nothing."""
    monkeypatch.delenv("GLASS_TPU_REMAT", raising=False)
    assert not modules._remat_enabled()
    monkeypatch.setenv("GLASS_TPU_REMAT", "1")
    calls, real = [], modules.checkpoint
    monkeypatch.setattr(modules, "checkpoint",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    ei, x, pos, _ = remat_problem()
    g = build_graph(ei, None, N, "gcn", device="cpu")
    model = GLASS(8, 16, 2, (2,), ("size",), dropout=0.5, device="cpu")
    with torch.no_grad():
        model(g, torch.from_numpy(x), torch.from_numpy(pos))
    assert calls == []
    gen = torch.Generator().manual_seed(0)
    model(g, torch.from_numpy(x), torch.from_numpy(pos), training=True,
          generator=gen)
    assert len(calls) == 2


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("rows", [None, (5, 40)], ids=["whole", "block"])
def test_predrawn_mask_is_the_forward_draw(rate, rows):
    """Dropout.draw then forward(keep=...) equals forward's own draw, bit
    for bit, with the generator left in the same state; on a node block
    (``rows``: first global row 5 of 40) the mask is the whole graph's
    rows 5.. and its padding rows past the global count keep their
    values."""
    x = torch.randn(38, 7, generator=torch.Generator().manual_seed(3))
    drop = Dropout(rate)
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    want = drop(x, training=True, generator=g1, rows=rows)
    keep = drop.draw(x.shape, x.device, training=True, generator=g2, rows=rows)
    got = drop(x, training=True, generator=None, rows=rows, keep=keep)
    assert torch.equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert (keep is None) == (rate in (0.0, 1.0))
    if rows is not None and keep is not None:
        assert keep[35:].all()  # rows 40.. of the block are padding
        assert torch.equal(got[35:], x[35:] / (1 - rate))


@pytest.mark.parametrize("mode", ["dense", "band"])
def test_remat_matches_jax_remat(monkeypatch, mode):
    """The port's Trainer and JAX's, both under GLASS_TPU_REMAT=1, dropout
    0, 3 steps from the same parameters (tests/test_torch_train.py's
    problem and tolerances)."""
    monkeypatch.setenv("GLASS_TPU_REMAT", "1")
    _, res, ref_losses, worst = run_both_trainers(
        trainer_inputs(np.random.default_rng(0)), mode)
    np.testing.assert_allclose(res.step_losses, ref_losses, rtol=1e-4)
    assert worst <= 3 * LR, worst


def test_remat_on_sharded_ranks_keeps_their_mask_rows(monkeypatch):
    """multihost.run_smoke (dropout 0.1, 2 conv layers) on a 1 x 2 mesh of
    gloo ranks, remat on against off: every rank's step and epoch losses
    equal, bit for bit (each rank draws the whole graph's mask before its
    checkpointed conv and keeps its block's rows; the recomputed body
    all-reduces GraphNorm's statistics again)."""
    runs = {}
    for remat in ("0", "1"):
        monkeypatch.setenv("GLASS_TPU_REMAT", remat)
        runs[remat] = spawn(R.dropout_smoke, 2, args=(1, 2), timeout=600)
    assert runs["1"] == runs["0"]
    assert runs["0"][0] == runs["0"][1]

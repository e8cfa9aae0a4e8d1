"""The port's training pieces against glass_tpu's.

The same numpy inputs go through ``glass_tpu.train`` and its counterparts in
``glass_tpu_torch.train``: the losses (against optax), the plateau schedule
(float32, ties at the threshold included), the batches (equal), the F1
metrics (against the sklearn path, exactly) and a whole ``Trainer`` epoch of
3 steps with dropout 0, in dense, BCSR and band SpMM modes: per-step losses
within rtol 1e-4 and parameters after 3 steps within atol 3 * lr (Adam
moves every parameter by about lr per step whatever the size of its
gradient, so a rounding difference in a near-zero gradient can turn a step;
the gradients themselves are held at rtol 1e-4 in tests/test_torch_model.py).
With ``compute_dtype="bfloat16"`` (flax ``dtype="bfloat16"``), on f32,
bf16 and int8 adjacencies: losses within rtol 3e-3 (measured at most
2.0e-3 over seeds 0-4 and the four layouts below; bf16 rounds at other
places in the two frameworks) and parameters within 3 * lr (measured at
most 2.32 * lr).
Dropout's own semantics are checked on the port alone: its stream differs
from the TPU's by design.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.nn.modules import GLASS as FlaxGLASS
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.train import loop as jloop
from glass_tpu.train import metrics as jmetrics
from glass_tpu.train import schedule as jschedule
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import GLASS, build_graph, params_from_flax
from glass_tpu_torch.nn.dropout import Dropout
from glass_tpu_torch.train import loop as tloop
from glass_tpu_torch.train import metrics as tmetrics
from glass_tpu_torch.train import schedule as tschedule

LR = 1e-3


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("kind", ["bce", "ce"])
def test_losses_match_optax(rng, kind):
    logits = (3 * rng.normal(size=(7, 4))).astype(np.float32)
    if kind == "bce":
        y = (rng.random((7, 4)) > 0.5).astype(np.float32)
    else:
        y = rng.integers(0, 4, 7)
    ref = float(jloop.LOSSES[kind](jnp.asarray(logits), jnp.asarray(y)))
    out = float(tloop.LOSSES[kind](torch.from_numpy(logits), torch.from_numpy(y)))
    assert out == pytest.approx(ref, rel=1e-6)


# ---------------------------------------------------------------- schedule


def test_plateau_matches_jax_including_threshold_ties():
    best = np.float32(0.8)
    tie = best * np.float32(1 - 1e-4)  # not better: the test is strict
    below = np.nextafter(tie, np.float32(0))  # better by one ulp
    losses = ([1.0, 0.9, best, tie, below] + [below] * 4 + [1.0] * 9
              + [0.5] + [0.5] * 40)
    js, ts = jschedule.plateau_init(0.01), tschedule.plateau_init(0.01)
    for i, loss in enumerate(losses):
        js = jschedule.plateau_step(js, loss, factor=0.5, min_lr=1e-3,
                                    patience=3)
        ts = tschedule.plateau_step(ts, loss, factor=0.5, min_lr=1e-3,
                                    patience=3)
        assert (np.float32(js.lr), np.float32(js.best), int(js.num_bad)) == \
            (ts.lr, ts.best, ts.num_bad), f"step {i}"
    assert ts.lr == np.float32(1e-3)  # reached min_lr


# ----------------------------------------------------------------- batches


def test_batches_equal(rng):
    pos = rng.integers(-1, 50, (23, 7))
    y = rng.integers(0, 3, 23)
    for a, b in zip(jloop.make_train_batches(np.random.default_rng(3), pos, y, 5),
                    tloop.make_train_batches(np.random.default_rng(3), pos, y, 5)):
        np.testing.assert_array_equal(a, b)
    for rng_seed in (None, 4):
        ja = jloop.make_eval_batches(
            pos, y, 5, None if rng_seed is None else np.random.default_rng(rng_seed))
        ta = tloop.make_eval_batches(
            pos, y, 5, None if rng_seed is None else np.random.default_rng(rng_seed))
        np.testing.assert_array_equal(ja[0], ta[0])
        np.testing.assert_array_equal(ja[1], ta[1])
        assert ja[2] == ta[2]
    with pytest.raises(ValueError, match="batch_size"):
        tloop.make_train_batches(rng, pos, y, 24)


# ----------------------------------------------------------------- metrics


def metric_case(kind, rng, n=37):
    if kind == "binary":
        return rng.normal(size=(n, 1)), (rng.random(n) > 0.4).astype(np.float32)
    if kind == "multilabel":
        return rng.normal(size=(n, 3)), (rng.random((n, 3)) > 0.6).astype(np.float32)
    return rng.normal(size=(n, 4)), rng.integers(0, 4, n)


@pytest.mark.parametrize("kind", ["binary", "multilabel", "multiclass"])
def test_metrics_match_sklearn_path(rng, kind):
    pred, label = metric_case(kind, rng)
    if kind == "multiclass":
        assert tmetrics.micro_f1(pred, label) == jmetrics.micro_f1(pred, label)
    else:
        assert tmetrics.binary_f1(pred, label) == jmetrics.binary_f1(pred, label)
    bs = 5
    nb = -(-len(pred) // bs)
    y_pad, mask = tmetrics.pad_eval_labels(label, nb, bs)
    jy, jm = jmetrics.pad_eval_labels(label, nb, bs)
    np.testing.assert_array_equal(y_pad, jy)
    np.testing.assert_array_equal(mask, jm)
    logits = np.concatenate([pred, np.zeros((nb * bs - len(pred), pred.shape[1]))])
    logits = logits.reshape(nb, bs, -1).astype(np.float32)
    binary = kind != "multiclass"
    counts = tmetrics.device_metric_counts(
        torch.from_numpy(logits), torch.from_numpy(y_pad),
        torch.from_numpy(mask), binary)
    ref = jmetrics.device_metric_counts(
        jnp.asarray(logits), jnp.asarray(y_pad), jnp.asarray(mask), binary)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref))
    assert counts.dtype == torch.int32
    assert tmetrics.score_from_counts(counts) == jmetrics.score_from_counts(ref)


def test_score_of_empty_counts_is_zero():
    assert tmetrics.score_from_counts((0, 0, 0)) == 0.0 == \
        jmetrics.score_from_counts(np.zeros(3, np.int32))


# ----------------------------------------------------------------- dropout


def test_dropout_keeps_bf16():
    """A bf16 activation stays bf16 through dropout, as in the JAX module;
    kept values are x / (1 - rate) rounded to bf16."""
    x = torch.randn(300, 40).to(torch.bfloat16)
    out = Dropout(0.3)(x, training=True,
                       generator=torch.Generator().manual_seed(0))
    assert out.dtype == torch.bfloat16
    kept = out != 0
    assert torch.equal(out[kept], (x / 0.7)[kept])


def test_dropout_identity_and_zeros():
    x = torch.randn(50, 8)
    g = torch.Generator().manual_seed(0)
    assert Dropout(0.0)(x, training=True, generator=g) is x
    assert Dropout(0.7)(x, training=False) is x
    assert not Dropout(1.0)(x, training=True).any()
    with pytest.raises(ValueError, match="Generator"):
        Dropout(0.3)(x, training=True)
    with pytest.raises(ValueError, match="rate"):
        Dropout(1.5)


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_keep_fraction_scaling_and_seed(rate):
    x = torch.ones(400, 500)
    out = Dropout(rate)(x, training=True,
                        generator=torch.Generator().manual_seed(1))
    kept = out != 0
    # 200,000 Bernoulli draws: the keep fraction within 5 standard errors
    se = np.sqrt(rate * (1 - rate) / x.numel())
    assert abs(kept.float().mean().item() - (1 - rate)) < 5 * se
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / (1 - rate)))
    again = Dropout(rate)(x, training=True,
                          generator=torch.Generator().manual_seed(1))
    other = Dropout(rate)(x, training=True,
                          generator=torch.Generator().manual_seed(2))
    assert torch.equal(out, again) and not torch.equal(out, other)


# ----------------------------------------------------------------- Trainer

N_NODE, MAX_DEG, HIDDEN, LAYERS, BATCH = 4 * 128, 6, 16, 2, 6


def trainer_inputs(rng):
    """A directed graph with a diagonal band (its 'mean' normalization is
    asymmetric, so the backward runs over the transposed layouts), degree
    features and 18 size-labelled subgraphs."""
    src = rng.integers(0, N_NODE, 2500)
    dst = np.clip(src + rng.integers(-150, 150, src.size), 0, N_NODE - 1)
    ei = np.stack([src, dst])
    x = rng.integers(0, MAX_DEG + 1, (N_NODE, 1))
    pos = np.full((3 * BATCH, 12), -1, np.int64)
    y = np.zeros(3 * BATCH, np.float32)
    for i in range(3 * BATCH):
        k = int(rng.integers(2, 13))
        pos[i, :k] = rng.choice(N_NODE, k, replace=False)
        y[i] = k > 7
    return ei, x, pos, y


def run_both_trainers(inputs, mode, dense_dtype="f32", compute_dtype=None):
    """A 3-step epoch of the JAX and the port's Trainer from the same
    parameters on ``trainer_inputs``: (the port's Trainer and its
    EpochResult, JAX's per-step losses, max |port - JAX| over the final
    parameters)."""
    ei, x, pos, y = inputs
    kw = (dict(materialize_dense=True) if mode == "dense" else
          dict(materialize_dense=False, materialize_bcsr=True,
               sparse_layout=mode))
    spmm_mode = "dense" if mode == "dense" else "pallas"
    jg = jax_build_graph(ei, None, N_NODE, "mean", dense_dtype=dense_dtype,
                         **kw)
    tg = build_graph(ei, None, N_NODE, "mean", dense_dtype=dense_dtype,
                     device="cpu", **kw)
    assert (tg.band if mode == "band" else tg.bcsr if mode == "bcsr"
            else tg.dense if tg.dense_q is None else tg.dense_q) is not None
    pos_b, y_b = tloop.make_train_batches(np.random.default_rng(5), pos, y,
                                          BATCH)

    fm = FlaxGLASS(max_deg=MAX_DEG, hidden_channels=HIDDEN, num_layers=LAYERS,
                   output_channels=(1,), pools=("size",), dropout=0.0,
                   activation="elu", z_ratio=0.75, jk=True,
                   spmm_mode=spmm_mode, dtype=compute_dtype)
    jt = jloop.Trainer(fm, jg, jnp.asarray(x),
                       jloop.TrainConfig(lr=LR, batch_size=BATCH, loss="bce"),
                       donate=False)
    params, opt_state, plateau = jt.init(0, jnp.asarray(pos_b[0]))
    init = _flatten(params)
    rng_key = jax.random.PRNGKey(1)
    ref_losses = []
    for pos_s, y_s in zip(pos_b, y_b):  # one-step epochs: per-step losses
        params, opt_state, plateau, rng_key, loss = jt.train_epoch(
            params, opt_state, plateau, rng_key, jnp.asarray(pos_s[None]),
            jnp.asarray(y_s[None]))
        ref_losses.append(float(loss))

    model = params_from_flax(
        GLASS(MAX_DEG, HIDDEN, LAYERS, (1,), ("size",), dropout=0.0,
              activation="elu", z_ratio=0.75, jk=True, spmm_mode=spmm_mode,
              compute_dtype=compute_dtype, device="cpu"), init)
    trainer = tloop.Trainer(model, tg, torch.from_numpy(x),
                            tloop.TrainConfig(lr=LR, batch_size=BATCH,
                                              loss="bce"))
    trainer.init(0)
    res = trainer.train_epoch(pos_b, y_b)
    final = {k: v.numpy() for k, v in model.state_dict().items()}
    ported = params_from_flax(
        GLASS(MAX_DEG, HIDDEN, LAYERS, (1,), ("size",), device="cpu"),
        _flatten(params))
    worst = max(float(np.abs(final[k] - v.numpy()).max())
                for k, v in ported.state_dict().items())
    return trainer, res, ref_losses, worst


@pytest.mark.parametrize("mode", ["dense", "bcsr", "band"])
def test_trainer_matches_jax_trainer(rng, mode):
    inputs = trainer_inputs(rng)
    trainer, res, ref_losses, worst = run_both_trainers(inputs, mode)
    np.testing.assert_allclose(res.step_losses, ref_losses, rtol=1e-4)
    assert res.loss == pytest.approx(np.mean(res.step_losses), rel=1e-6)
    assert worst <= 3 * LR, worst

    _, _, pos, y = inputs
    pos_e, y_e, n_real = tloop.make_eval_batches(pos, y, 4)
    y_pad, mask = tmetrics.pad_eval_labels(y_e, pos_e.shape[0], 4)
    score = trainer.evaluate_score(pos_e, y_pad, mask)
    assert score == tmetrics.binary_f1(trainer.evaluate(pos_e, n_real), y_e)


@pytest.mark.parametrize("mode, dense_dtype", [
    ("dense", "f32"), ("band", "int8"), ("bcsr", "bf16"), ("dense", "int8")])
def test_trainer_bf16_compute_matches_jax_trainer(rng, mode, dense_dtype):
    """Mixed precision trains as the JAX Trainer does (tolerances in the
    module docstring); parameters and Adam's state stay f32."""
    trainer, res, ref_losses, worst = run_both_trainers(
        trainer_inputs(rng), mode, dense_dtype, "bfloat16")
    assert np.isfinite(res.step_losses).all()
    np.testing.assert_allclose(res.step_losses, ref_losses, rtol=3e-3)
    assert worst <= 3 * LR, worst
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    for state in trainer.optimizer.state.values():
        assert all(v.dtype == torch.float32 for v in state.values()
                   if v.dim())


def test_trainer_needs_init_and_one_device(rng):
    ei, x, pos, y = trainer_inputs(rng)
    tg = build_graph(ei, None, N_NODE, "mean", device="cpu")
    model = GLASS(MAX_DEG, HIDDEN, LAYERS, (1,), ("size",), device="cpu")
    trainer = tloop.Trainer(model, tg, torch.from_numpy(x),
                            tloop.TrainConfig(loss="bce"))
    with pytest.raises(RuntimeError, match="init"):
        trainer.train_epoch(pos[None, :BATCH], y[None, :BATCH])
    with pytest.raises(ValueError, match="several devices"):
        tloop.Trainer(model, tg, torch.from_numpy(x).to("meta"),
                      tloop.TrainConfig())


def test_trainer_with_dropout_is_seeded(rng):
    """Dropout on: one seed gives one loss sequence, another seed another."""
    ei, x, pos, y = trainer_inputs(rng)
    tg = build_graph(ei, None, N_NODE, "mean", materialize_bcsr=True,
                     sparse_layout="band", device="cpu")
    pos_b, y_b = tloop.make_train_batches(np.random.default_rng(6), pos, y,
                                          BATCH)

    def run(seed):
        model = GLASS(MAX_DEG, HIDDEN, LAYERS, (1,), ("size",), dropout=0.5,
                      spmm_mode="pallas", seed=3, device="cpu")
        trainer = tloop.Trainer(model, tg, torch.from_numpy(x),
                                tloop.TrainConfig(loss="bce"))
        trainer.init(seed)
        return trainer.train_epoch(pos_b, y_b).step_losses

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and not np.array_equal(a, c)

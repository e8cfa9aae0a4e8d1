"""``Trainer.train_epochs`` of the port (``glass_tpu_torch/train/loop.py``)
on the CPU: against K ``train_epoch`` calls of the port and against JAX's
``Trainer.train_epochs``.

- K = 3 epochs through ``train_epochs`` equal three ``train_epoch`` calls
  bit for bit (epoch losses, every parameter, Adam's state, the plateau
  state and the dropout generator's state), with dropout off and on and a
  plateau set to cut the learning rate after every epoch but the first
  (patience 0, threshold 0.5), in dense, BCSR and band modes.
- The same K epochs against ``glass_tpu.train.loop.Trainer.train_epochs``
  from the same flax parameters with dropout 0 and f32: epoch losses within
  rtol 1e-4 and parameters within 3 * lr, the tolerances of
  tests/test_torch_train.py's one-epoch parity (Adam moves every parameter
  by about lr a step, so a rounding difference in a near-zero gradient can
  turn a step).
- A run state saved and loaded keeps the optimizer's own learning-rate
  object (on the card, the device tensor a captured step reads).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glass_tpu.nn.modules import GLASS as FlaxGLASS
from glass_tpu.ops.graph import build_graph as jax_build_graph
from glass_tpu.train import loop as jloop
from glass_tpu.utils.checkpoint import _flatten
from glass_tpu_torch import GLASS, build_graph, params_from_flax
from glass_tpu_torch.train import loop as tloop
from glass_tpu_torch.utils.checkpoint import load_run_state, save_run_state
# both planners under the JAX planner's constants (autouse)
from test_torch_planner import jax_planner_constants  # noqa: F401
from test_torch_train import BATCH, HIDDEN, LAYERS, LR, MAX_DEG, N_NODE
from test_torch_train import trainer_inputs

K = 3
MODES = ("dense", "bcsr", "band")
# a plateau that cuts the rate after every epoch but the first (whose loss
# sets the best), so each epoch of train_epochs must take the rate the
# previous epoch's plateau step left
CUTTING = dict(plateau_patience=0, plateau_threshold=0.5, resi=0.5)


def graph_kwargs(mode):
    if mode == "dense":
        return dict(materialize_dense=True)
    return dict(materialize_dense=False, materialize_bcsr=True,
                sparse_layout=mode)


def epochs_batches(pos, y):
    rng = np.random.default_rng(7)
    batches = [tloop.make_train_batches(rng, pos, y, BATCH) for _ in range(K)]
    return (np.stack([b[0] for b in batches]),
            np.stack([b[1] for b in batches]))


def port_trainer(tg, x, mode, dropout, init=None, **cfg):
    model = GLASS(MAX_DEG, HIDDEN, LAYERS, (1,), ("size",), dropout=dropout,
                  activation="elu", z_ratio=0.75, jk=True,
                  spmm_mode="dense" if mode == "dense" else "pallas", seed=3,
                  device="cpu")
    if init is not None:
        params_from_flax(model, init)
    trainer = tloop.Trainer(model, tg, torch.from_numpy(x),
                            tloop.TrainConfig(lr=LR, batch_size=BATCH,
                                              loss="bce", **cfg))
    trainer.init(11)
    return trainer


def assert_same_state(a: tloop.Trainer, b: tloop.Trainer):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for idx, state in sa["state"].items():
        for name, v in state.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][idx][name])), name
    assert a.plateau == b.plateau
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("mode", MODES)
def test_train_epochs_equals_train_epoch_calls(rng, mode, dropout):
    ei, x, pos, y = trainer_inputs(rng)
    tg = build_graph(ei, None, N_NODE, "mean", device="cpu",
                     **graph_kwargs(mode))
    pos_bs, y_bs = epochs_batches(pos, y)
    many = port_trainer(tg, x, mode, dropout, **CUTTING)
    one = port_trainer(tg, x, mode, dropout, **CUTTING)
    losses = many.train_epochs(pos_bs, y_bs)
    singles = [one.train_epoch(p, t).loss for p, t in zip(pos_bs, y_bs)]
    assert losses.dtype == np.float32 and losses.shape == (K,)
    np.testing.assert_array_equal(losses, np.float32(singles))
    assert_same_state(many, one)
    assert many.plateau.lr == np.float32(LR * 0.5 ** (K - 1))


@pytest.mark.parametrize("mode", MODES)
def test_train_epochs_matches_jax_train_epochs(rng, mode):
    ei, x, pos, y = trainer_inputs(rng)
    kw = graph_kwargs(mode)
    jg = jax_build_graph(ei, None, N_NODE, "mean", **kw)
    tg = build_graph(ei, None, N_NODE, "mean", device="cpu", **kw)
    pos_bs, y_bs = epochs_batches(pos, y)

    fm = FlaxGLASS(max_deg=MAX_DEG, hidden_channels=HIDDEN, num_layers=LAYERS,
                   output_channels=(1,), pools=("size",), dropout=0.0,
                   activation="elu", z_ratio=0.75, jk=True,
                   spmm_mode="dense" if mode == "dense" else "pallas")
    jt = jloop.Trainer(fm, jg, jnp.asarray(x),
                       jloop.TrainConfig(lr=LR, batch_size=BATCH, loss="bce",
                                         **CUTTING), donate=False)
    params, opt_state, plateau = jt.init(0, jnp.asarray(pos_bs[0, 0]))
    init = _flatten(params)
    params, _, plateau, _, ref = jt.train_epochs(
        params, opt_state, plateau, jax.random.PRNGKey(1),
        jnp.asarray(pos_bs), jnp.asarray(y_bs))

    trainer = port_trainer(tg, x, mode, 0.0, init, **CUTTING)
    losses = trainer.train_epochs(pos_bs, y_bs)
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    assert trainer.plateau.lr == np.float32(plateau.lr)
    final = trainer.model.state_dict()
    ported = params_from_flax(
        GLASS(MAX_DEG, HIDDEN, LAYERS, (1,), ("size",), device="cpu"),
        _flatten(params)).state_dict()
    worst = max(float((final[k] - v).abs().max()) for k, v in ported.items())
    assert worst <= 3 * LR, worst


def test_run_state_keeps_a_tensor_learning_rate(tmp_path):
    """Adam with a tensor learning rate (the card's) saves to JSON-able
    metadata and loads its state into the same rate object."""
    def make():
        torch.manual_seed(0)
        model = torch.nn.Linear(3, 2)
        opt = torch.optim.Adam(model.parameters(), lr=torch.tensor(0.01),
                               foreach=False)
        return model, opt, torch.Generator().manual_seed(5)

    model, opt, gen = make()
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    plateau = tloop.plateau_init(0.01)
    save_run_state(tmp_path / "s.npz", model=model, optimizer=opt,
                   plateau=plateau, generator=gen,
                   np_rng=np.random.default_rng(0), epoch=4, val_score=0.5,
                   tst_best=0.25, early_stop=1)
    model2, opt2, gen2 = make()
    lr = opt2.param_groups[0]["lr"]
    got, meta = load_run_state(tmp_path / "s.npz", model=model2,
                               optimizer=opt2, generator=gen2,
                               np_rng=np.random.default_rng(1))
    assert opt2.param_groups[0]["lr"] is lr
    assert got == plateau and meta["epoch"] == 4
    for p, q in zip(opt.state.values(), opt2.state.values()):
        for name in p:
            assert torch.equal(p[name], q[name]), name

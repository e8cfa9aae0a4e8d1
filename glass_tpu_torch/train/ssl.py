"""SSL link-prediction pretraining of node embeddings, the GNNEmb path
(counterpart of ``glass_tpu/train/ssl.py``; reference GNNEmb.py:108-199).

The protocol of ``pretrain_once``, as the JAX package runs it: the graph
built once (the "pallas" route's layout only under ``spmm_mode="pallas"``,
where the layout planner picks band, BCSR or hybrid; no RCM); the edges
and as many sampled non-edges as labelled pairs (``get_lp_dataset``), split
95/5 into training and validation pairs; per epoch up to
``batches_per_epoch`` shuffled batches of ``batch_size`` pairs, the plateau
schedule stepped on *every batch's* loss (factor 0.7, min_lr 5e-5,
patience 50); every ``eval_every`` epochs the binary F1 of the validation
pairs, the node table of the best score kept (a strict ``>``; the initial
table at score 0), and an early stop after ``early_stop`` evaluations
without a better one. The table is the (N, hidden) array GLASS warm-starts
from (``glass_test --use_nodeid``), in the graph's own node order.

The numpy ``rng`` is drawn in the JAX protocol's order (the dataset, the
95/5 permutation, one permutation per epoch), so both packages train on the
same batches. The training and validation pairs are copied to the device
once; each epoch copies the ``nb * bs`` entries of its permutation that it
uses, and each batch's pairs and labels are gathered on the device
(``index_select``) from its slice of them, the rows the numpy gather
``pos[order[ib * bs:(ib + 1) * bs]]`` selects.

JAX jits the step, the node table and the validation logits
(``glass_tpu/train/ssl.py:102-122``); the port captures them
(``utils/graphs.py``). On a CUDA card every batch (all of a run's have
``bs`` rows) replays one captured step (the batch gather, forward,
backward and ``torch.optim.Adam`` with optax.adam's defaults, capturable,
its rate a device tensor written from the plateau state before each
step) after the first, which runs eagerly; the node table and the
validation logits are one captured program each, on the step's stream. The
loss is read back after each step, which the per-batch schedule needs
(JAX's ``float(loss)``). On the CPU every step and evaluation runs
eagerly; on the card only with ``_graphed=False``, which exists to compare
the two. Dropout masks come from a ``torch.Generator`` on the device,
seeded by ``seed`` and registered with the captured step: its stream
differs from JAX's (ROADMAP Queue 3, "Limits of parity").

``run_hpo`` searches ``SEARCH_SPACE`` (GNNEmb.py:169-199) through the
sqlite shim of ``compat/optuna_lite.py``, installed optuna or not.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from glass_tpu_torch.compat import optuna_lite
from glass_tpu_torch.data.basegraph import BaseGraphData
from glass_tpu_torch.data.loaders import load_dataset
from glass_tpu_torch.nn.pretrain import EdgeGNN
from glass_tpu_torch.ops._common import resolve_device
from glass_tpu_torch.ops.graph import build_graph
from glass_tpu_torch.train.loop import adam, bce_with_logits, set_lr
from glass_tpu_torch.train.metrics import binary_f1
from glass_tpu_torch.train.protocol import apply_feature
from glass_tpu_torch.train.schedule import plateau_init, plateau_step
from glass_tpu_torch.utils.graphs import (InferencePrograms, TrainingStep,
                                          on_stream)


@dataclasses.dataclass
class SSLConfig:
    """The fields of the JAX class, plus ``device`` ("cuda", the default,
    or "cpu")."""

    dataset: str = "ppi_bp"
    # the reference recipe runs GNNEmb with --use_nodeid (README:55-57):
    # x = arange(N), a free trainable embedding row per node
    feature: str = "nodeid"
    hidden_dim: int = 64
    conv_layer: int = 3
    dropout: float = 0.3
    aggr: str = "mean"
    jk: int = 0
    lr: float = 1e-3
    batch_size: int = 131072
    max_epochs: int = 100
    batches_per_epoch: int = 10
    eval_every: int = 5
    early_stop: int = 3
    repeat: int = 1
    spmm_mode: Optional[str] = None
    data_root: Optional[str] = None
    device: str = "cuda"


def pretrain_once(
    cfg: SSLConfig,
    base: BaseGraphData,
    seed: int,
    log: Callable[[str], None] = print,
    init_state: Optional[Dict[str, torch.Tensor]] = None,
    *,
    _graphed: bool = True,
) -> Tuple[float, np.ndarray]:
    """One pretraining run; returns (best val F1, best (N, hidden) table).
    The model's parameters are drawn from ``seed``, or loaded from
    ``init_state`` (an ``EdgeGNN`` state dict) where it is given.
    ``_graphed=False`` runs the steps and evaluations eagerly on the card
    too (module docstring)."""
    dev = resolve_device(cfg.device)
    rng = np.random.default_rng(seed)
    graph = build_graph(
        base.edge_index, base.edge_weight, base.n_node, cfg.aggr,
        materialize_dense=(None if cfg.spmm_mode is None
                           else cfg.spmm_mode == "dense"),
        materialize_bcsr=cfg.spmm_mode == "pallas", device=dev)
    pos_all, y_all = base.get_lp_dataset(rng)
    # 95/5 train/val split of the pairs (reference: GNNEmb.py:59-64)
    perm = rng.permutation(pos_all.shape[0])
    trn_len = int(0.95 * perm.shape[0])
    trn_idx, val_idx = perm[:trn_len], perm[trn_len:]
    pos_trn = torch.from_numpy(pos_all[trn_idx]).to(dev)
    y_trn = torch.from_numpy(y_all[trn_idx]).to(dev)
    pos_val = torch.from_numpy(pos_all[val_idx]).to(dev)
    y_val = y_all[val_idx]
    del pos_all, y_all, perm, trn_idx

    model = EdgeGNN(base.max_deg, cfg.hidden_dim, cfg.conv_layer,
                    dropout=cfg.dropout, activation="relu", jk=bool(cfg.jk),
                    spmm_mode=cfg.spmm_mode, seed=seed, device=dev)
    if init_state is not None:
        model.load_state_dict(init_state)
    x = torch.from_numpy(base.x).to(dev)
    optimizer = adam(model.parameters(), cfg.lr, dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    plateau = plateau_init(cfg.lr)
    stream = (torch.cuda.Stream(dev) if dev.type == "cuda" and _graphed
              else None)

    def train_step(idx: torch.Tensor) -> torch.Tensor:
        """One step on the pairs of rows ``idx`` (bs,) of the training set,
        from cleared gradients; the loss."""
        logits = model(graph, x, pos_trn.index_select(0, idx), training=True,
                       generator=generator)
        loss = bce_with_logits(logits, y_trn.index_select(0, idx))
        loss.backward()
        optimizer.step()
        return loss.detach()

    step = TrainingStep(train_step, optimizer, generator)
    programs = InferencePrograms(dev)

    def node_table() -> np.ndarray:
        return programs(("node_table",), lambda: model.node_emb(graph, x), (),
                        stream).cpu().numpy()

    def val_score() -> float:
        logits = programs(("val_logits",), lambda: model(graph, x, pos_val),
                          (), stream)
        return binary_f1(logits.cpu().numpy(), y_val)

    best_score, best_emb, early = 0.0, node_table(), 0
    n_trn = pos_trn.shape[0]
    bs = min(cfg.batch_size, n_trn)
    nb = min(cfg.batches_per_epoch, n_trn // bs or 1)
    for epoch in range(cfg.max_epochs):
        order = rng.permutation(n_trn)
        order = torch.from_numpy(order[: nb * bs]).to(dev)  # what it uses
        losses = []
        with on_stream(stream):
            for ib in range(nb):
                set_lr(optimizer, plateau.lr)
                loss = float(step(order[ib * bs: (ib + 1) * bs],
                                  stream=stream))
                # the reference steps the scheduler on every batch
                # (GNNEmb.py:139)
                plateau = plateau_step(plateau, loss, factor=0.7,
                                       min_lr=5e-5, patience=50)
                losses.append(loss)
        if epoch % cfg.eval_every == 0:
            score = val_score()
            log(f"iter {epoch} loss {np.average(losses):.4f} score {score:.4f}")
            early += 1
            if score > best_score:
                best_score, best_emb, early = score, node_table(), 0
            if early >= cfg.early_stop:
                break
        else:
            log(f"iter {epoch} loss {np.average(losses):.4f}")
    return best_score, best_emb


def pretrain(cfg: SSLConfig, log: Callable[[str], None] = print):
    """Repeats (GNNEmb.py:116-163): returns (mean - std of the scores, the
    last repeat's best table)."""
    base = load_dataset(cfg.dataset, np.random.default_rng(0), cfg.data_root)
    apply_feature(base, cfg.feature)
    scores, emb = [], None
    for r in range(cfg.repeat):
        s, emb = pretrain_once(cfg, base, seed=r, log=log)
        scores.append(s)
    return float(np.average(scores) - np.std(scores)), emb


# The HPO space of GNNEmb.py:176-183.
SEARCH_SPACE = dict(
    conv_layer=[2, 3, 4, 5],
    dropout=[0.0, 0.1, 0.2, 0.3, 0.4, 0.5],
    aggr=["sum", "mean", "gcn"],
)


def search_space(trial_like):
    """The HPO space of GNNEmb.py:176-183, through a suggest callback."""
    return {
        name: trial_like(name, choices)
        for name, choices in SEARCH_SPACE.items()
    }


def run_hpo(
    cfg: SSLConfig,
    n_trials: int,
    save_fn: Callable[[np.ndarray], None],
    log: Callable[[str], None] = print,
    storage: Optional[str] = None,
    sampler: str = "tpe",
):
    """The resumable study of GNNEmb.py:194-199 on the port's sqlite shim
    (``compat/optuna_lite.py``), with its TPE or, for ``sampler="random"``,
    its seeded random sampler, whether or not optuna is installed: the
    study's draws and file never depend on the machine's packages. Both
    samplers draw each parameter as a pure function of (seed, trial number,
    name, history), so a resumed study makes the draws an uninterrupted one
    makes.

    ``n_trials`` is the study's TOTAL budget: restored trials count against
    it and are never trained again (the reference runs ``n_trials`` more on
    every invocation). ``save_fn`` gets the table of every trial that beats
    the best score so far. Returns {"score", "params"} of the best trial."""
    if sampler not in ("tpe", "random"):
        raise ValueError(f"unknown sampler {sampler!r} (tpe | random)")
    best = {"score": -np.inf}

    def objective_with(params: dict) -> float:
        trial_cfg = dataclasses.replace(cfg, **params)
        score, emb = pretrain(trial_cfg, log=log)
        if score > best["score"]:
            best.update(score=score, params=params)
            save_fn(emb)
        return score

    sampler_obj = (optuna_lite.LiteTPESampler(seed=0) if sampler == "tpe"
                   else optuna_lite.LiteRandomSampler(seed=0))

    def obj(trial):
        params = search_space(
            lambda name, choices: trial.suggest_categorical(name, choices)
        )
        return objective_with(params)

    study = optuna_lite.create_study(
        direction="maximize",
        storage=storage,
        study_name=cfg.dataset,
        load_if_exists=storage is not None,
        sampler=sampler_obj,
    )
    done = [t for t in study.trials if t.value is not None]
    if done:
        top = max(done, key=lambda t: t.value)
        best.update(score=top.value, params=dict(top.params))
        log(f"resumed study: {len(done)} completed trials")
    remaining = max(0, n_trials - len(done))
    for _ in range(remaining):  # one trial per optimize: log params as drawn
        study.optimize(obj, n_trials=1)
        tr = study.trials[-1]
        log(f"trial {tr.number}: {tr.params} -> {tr.value:.4f}")
    # only a study with completed trials has best params
    completed = [t for t in study.trials if t.value is not None]
    log(f"best params {study.best_params if completed else None}")
    log(f"best valf1 {best['score']}")
    return best

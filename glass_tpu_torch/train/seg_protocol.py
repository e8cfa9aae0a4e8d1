"""GNN-seg experiment protocol (counterpart of
``glass_tpu/train/seg_protocol.py``; reference GNNSeg.py:283-345).

As the JAX package runs it, and unlike the GLASS protocol: up to 500
epochs; the batch size is the test split's size; each epoch takes
``rng.permutation(n_trn)[: nb * min(batch_size, n_trn)]`` from
``np.random.default_rng(repeat)`` in ``nb = max(n_trn // batch_size, 1)``
batches (the remainder dropped); the plateau schedule (factor 0.7, min_lr
5e-5) steps on the epoch's mean loss; every 5 epochs val and, on a new
best or a tie within 1e-5, test are scored in |test|-sized batches, in
order (GraphNorm couples the subgraphs of one batch, so the batch
boundaries are part of the result); the early counter goes up by 1 each
eval, is halved on a new best or a tie, and the run stops once it passes
10.

The splits' tensors are copied to the device once, and each epoch's
(nb, B) order once an epoch. JAX runs an epoch as one jitted scan and
jits ``infer`` (``glass_tpu/train/seg_protocol.py:80-106``); the port
captures them (``utils/graphs.py``). On a CUDA card every step of a repeat
after its first replays one captured step: the host refreshes its static
(B,) row buffer from the order (one device-to-device copy), and the graph
gathers the batch from the resident training split (``index_select``),
runs the forward, the backward and ``torch.optim.Adam`` (optax.adam's
defaults, capturable, its rate a device tensor set each epoch). Each
step's loss goes into an (nb,) device buffer whose mean is read back once
an epoch, which the schedule needs (JAX syncs no more often). Every eval
batch shape (the val split's full batches, its remainder, the test split)
replays one captured forward, on the step's stream. Each repeat builds a
new model, and so new captures. On the CPU every step and eval runs
eagerly; on the card only with ``_graphed=False``, which exists to compare
the two. Dropout masks come from a ``torch.Generator`` on the device
seeded by the repeat and registered with the captured step; its stream
differs from JAX's (ROADMAP Queue 3, "Limits of parity"). Parameters are
drawn from the repeat as the seed, or loaded from ``init_state``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from glass_tpu_torch.data.loaders import SYNTHETIC_DATASETS, load_dataset
from glass_tpu_torch.data.seg import SegData, segregate
from glass_tpu_torch.nn.seg import GSegGNN
from glass_tpu_torch.ops._common import resolve_device
from glass_tpu_torch.train.loop import LOSSES, adam, set_lr
from glass_tpu_torch.train.metrics import binary_f1, micro_f1
from glass_tpu_torch.train.schedule import plateau_init, plateau_step
from glass_tpu_torch.utils.graphs import (InferencePrograms, TrainingStep,
                                          on_stream)

BEST_HYPERPARAMS = {  # reference: GNNSeg.py:348-389
    "density": dict(conv_layer=1, dropout=0.4, hidden_dim=16),
    "component": dict(conv_layer=1, dropout=0.0, hidden_dim=16),
    "coreness": dict(conv_layer=1, dropout=0.3, hidden_dim=16),
    "cut_ratio": dict(conv_layer=1, dropout=0.1, hidden_dim=4),
    "hpo_neuro": dict(conv_layer=1, dropout=0.4, hidden_dim=64),
    "ppi_bp": dict(conv_layer=8, dropout=0.4, hidden_dim=64),
    "hpo_metab": dict(conv_layer=1, dropout=0.1, hidden_dim=64),
    "em_user": dict(conv_layer=1, dropout=0.4, hidden_dim=64),
}


@dataclasses.dataclass
class SegConfig:
    """The fields of the JAX class, plus ``device`` ("cuda", the default,
    or "cpu")."""

    dataset: str = "density"
    hidden_dim: int = 64
    conv_layer: int = 8
    dropout: float = 0.3
    lr: float = 1e-3
    repeat: int = 1
    max_epochs: int = 500
    data_root: Optional[str] = None
    device: str = "cuda"


class SegTensors(NamedTuple):
    """One split's (or batch's) tensors on the device."""

    adj_norm: torch.Tensor  # (S, L, L) f32
    adj_sum: torch.Tensor  # (S, L, L) f32
    feats: torch.Tensor  # (S, L, F) f32
    mask: torch.Tensor  # (S, L) bool
    y: torch.Tensor  # (S,) or (S, K) f32 (BCE), (S,) int64 (CE)

    def take(self, idx) -> "SegTensors":
        """The rows ``idx``: views for a slice, gathered copies
        (``index_select``) for a (B,) index tensor."""
        if isinstance(idx, slice):
            return SegTensors(*(t[idx] for t in self))
        return SegTensors(*(t.index_select(0, idx) for t in self))


def to_device(d: SegData, ydtype, dev: torch.device) -> SegTensors:
    return SegTensors(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in (d.adj_norm, d.adj_sum, d.feats, d.mask,
                                  d.y.astype(ydtype))))


def train_step(model: GSegGNN, optimizer: torch.optim.Optimizer,
               loss_fn: Callable, batch: SegTensors,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One Adam step on ``batch``; returns the loss (on the device)."""
    optimizer.zero_grad(set_to_none=True)
    logits = model(batch.adj_norm, batch.adj_sum, batch.feats, batch.mask,
                   training=True, generator=generator)
    loss = loss_fn(logits, batch.y)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_epoch(step: TrainingStep, order: torch.Tensor,
                stream: Optional[torch.cuda.Stream] = None) -> float:
    """The steps of one epoch: ``step`` (a :class:`TrainingStep` over a (B,)
    row index of the training split) once for each row of the (nb, B)
    device ``order``, on ``stream`` if one is given; the steps' losses go
    into an (nb,) device buffer and their mean is read back once."""
    losses = torch.empty(order.shape[0], dtype=torch.float32,
                         device=order.device)
    with on_stream(stream):
        for i in range(order.shape[0]):
            losses[i] = step(order[i], stream=stream)
        return float(losses.mean())


def infer(model: GSegGNN, data: SegTensors, batch_size: int,
          programs: InferencePrograms,
          stream: Optional[torch.cuda.Stream] = None) -> np.ndarray:
    """The logits of every row of ``data`` in ``batch_size`` batches, in
    order (the reference's tloader: GNNSeg.py:290-292, batch_size=|test|,
    shuffle=False), gathered on the host: each batch through the program
    of its shape in ``programs``, captured on ``stream`` (eager without
    one)."""
    n = data.y.shape[0]
    outs = []
    for s in range(0, n, batch_size):
        b = data.take(slice(s, min(s + batch_size, n)))
        inputs = (b.adj_norm, b.adj_sum, b.feats, b.mask)
        key = tuple((tuple(t.shape), t.dtype) for t in inputs)
        outs.append(programs(key, model, inputs, stream).cpu().numpy())
    return np.concatenate(outs, axis=0)


def run_seg_experiment(cfg: SegConfig, log: Callable[[str], None] = print,
                       init_state: Optional[Dict[str, torch.Tensor]] = None,
                       *, _graphed: bool = True):
    """Runs ``cfg.repeat`` repeats; returns (test scores, mean, std error).
    ``init_state`` (a ``GSegGNN`` state dict), where given, is every
    repeat's initial state in place of the parameters drawn from it.
    ``_graphed=False`` runs the steps and evals eagerly on the card too
    (module docstring)."""
    dev = resolve_device(cfg.device)
    stream = (torch.cuda.Stream(dev) if dev.type == "cuda" and _graphed
              else None)
    base = load_dataset(cfg.dataset, np.random.default_rng(0), cfg.data_root)
    feature = "one" if cfg.dataset in SYNTHETIC_DATASETS else "deg"
    conv = "gin" if cfg.dataset == "density" else "gcn"

    binary = base.binary
    out_ch = base.output_channels
    loss_fn = LOSSES["bce" if binary else "ce"]
    score_fn = binary_f1 if binary else micro_f1
    ydtype = np.float32 if binary else np.int64

    splits = segregate(base, feature)
    trn, val, tst = (to_device(splits[s], ydtype, dev)
                     for s in ("train", "valid", "test"))
    y_val, y_tst = (splits[s].y.astype(ydtype) for s in ("valid", "test"))
    batch_size = tst.y.shape[0]
    n_feat = trn.feats.shape[-1]

    outs = []
    for repeat in range(cfg.repeat):
        log(f"repeat {repeat}")
        rng = np.random.default_rng(repeat)
        model = GSegGNN(n_feat, cfg.hidden_dim, out_ch, cfg.conv_layer,
                        dropout=cfg.dropout, activation="elu", conv=conv,
                        seed=repeat, device=dev)
        if init_state is not None:
            model.load_state_dict(init_state)
        optimizer = adam(model.parameters(), cfg.lr, dev)
        generator = torch.Generator(device=dev).manual_seed(repeat)
        plateau = plateau_init(cfg.lr)

        def trn_step(idx: torch.Tensor) -> torch.Tensor:
            return train_step(model, optimizer, loss_fn, trn.take(idx),
                              generator)

        step = TrainingStep(trn_step, optimizer, generator)
        programs = InferencePrograms(dev)

        def score(data: SegTensors, y: np.ndarray) -> float:
            return score_fn(infer(model, data, batch_size, programs, stream),
                            y)

        n_trn = trn.y.shape[0]
        nb = max(n_trn // batch_size, 1)
        val_score = tst_score = 0.0
        early = 0.0
        for i in range(cfg.max_epochs):
            order = rng.permutation(n_trn)[: nb * min(batch_size, n_trn)]
            set_lr(optimizer, plateau.lr)
            # the epoch's order, copied to the device once
            order = torch.from_numpy(order.reshape(nb, -1)).to(dev)
            loss = train_epoch(step, order, stream)
            plateau = plateau_step(plateau, loss, factor=0.7, min_lr=5e-5)
            if i % 5 == 0:
                s = score(val, y_val)
                early += 1
                if s > val_score:
                    val_score = s
                    tst_score = score(tst, y_tst)
                    log(f"iter {i} loss {loss:.4f} val {val_score:.4f} "
                        f"tst {tst_score:.4f}")
                    early /= 2
                elif s >= val_score - 1e-5:
                    probe = score(tst, y_tst)
                    tst_score = max(probe, tst_score)
                    log(f"iter {i} loss {loss:.4f} val {val_score:.4f} "
                        f"tst {probe:.4f}")
                    early /= 2
                else:
                    log(f"iter {i} loss {loss:.4f} val {s:.4f} "
                        f"tst {score(tst, y_tst):.4f}")
                if early > 10:
                    break
        log(f"end: val {val_score:.4f} tst {tst_score:.4f}")
        outs.append(tst_score)
    mean = float(np.average(outs))
    err = float(np.std(outs) / np.sqrt(len(outs)))
    log(f"tst scores {outs}")
    log(f"{mean} {err}")
    return outs, mean, err

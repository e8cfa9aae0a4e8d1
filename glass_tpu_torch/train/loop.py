"""Training and evaluation of GLASS (counterpart of
``glass_tpu/train/loop.py``).

Per step, as the JAX epoch program does it: the batch's zero-one labels
(``max_zero_one``), the whole-graph GLASS forward with dropout on, the loss,
the backward pass (every block-sparse SpMM's backward is its kernel over the
transposed layout) and an Adam step. The learning rate comes from the
plateau state at the start of each epoch, and the schedule advances on the
epoch's mean loss, read back once per epoch (the plateau is numpy f32, as
JAX's is, so that threshold ties fall alike). :meth:`Trainer.train_epochs`
runs K epochs of pre-drawn batches, the counterpart of JAX's multi-epoch
program, with the same math as K :meth:`Trainer.train_epoch` calls.

Where JAX scans an epoch in one XLA program, the port on a CUDA card
captures one step (forward, backward and the Adam update) into a
``torch.cuda.CUDAGraph`` (``utils/graphs.py::TrainingStep``, as the SSL
and GNN-seg steps are) and replays it per batch: per step the host copies
the batch into static (B, L) buffers, replays, and copies the loss into
the epoch's device buffer. The first step after :meth:`Trainer.init` (or a
new batch shape, or a loaded run state) runs eagerly on the graph's stream
and is a real step of the epoch; the capture follows it and runs nothing.
Kernel wrappers count their launches when they are called, so a captured
step counts once, at its capture, and its replays count nothing. A failed
capture raises; nothing falls back to the eager loop. On the CPU every step
runs eagerly; on the card only where ``Trainer._graphed`` is cleared, which
exists to compare the captured step with the eager one.

Under a profiler each epoch records a ``glass.train.epoch`` span (the
trainer's epoch count the ident) over ``glass.train.copy_in`` (the
batches to the device; in :meth:`Trainer.train_epochs` one span before
the K epochs), one ``glass.train.step`` a step (the copy into the static
buffers, the replay's enqueue and the loss's store; an eager step and its
capture, ``glass.capture``, inside it) and ``glass.train.readback`` (the
mean loss and the step losses to the host, the wait for the device
included); the plateau step stays in the epoch's self time
(``utils/profiling.py``).

Evaluation is JAX's jitted eval scan, ported the same way: on the card
:meth:`Trainer.evaluate` and :meth:`Trainer.evaluate_score` run all the
eval batches of one shape ``(nb, B, L)`` (``evaluate_score`` with the F1
counts taken inside, one int32 (3,) readback, as
``glass_tpu/train/loop.py::_eval_score_impl``) as one captured program
(``utils/graphs.py``) on the training step's stream: the first call of a
shape runs eagerly, the capture follows, later calls replay once per
evaluation. The protocol re-draws its val and test batches every epoch
but keeps their shapes, so each split gets one program. :meth:`Trainer.init`
and :meth:`Trainer.load_run_state` drop them, as they drop the step.

Adam is ``torch.optim.Adam`` with optax.adam's defaults (betas 0.9/0.999,
eps 1e-8, no weight decay); on a CUDA card it is ``capturable`` and its
learning rate a device tensor, rewritten in place each epoch. Dropout
masks come from a ``torch.Generator`` on the model's device, seeded by
:meth:`Trainer.init` and registered with the captured graph, so replays
draw the masks the same steps draw eagerly; the stream differs from the
TPU's (ROADMAP Queue 3, "Limits of parity").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from glass_tpu_torch.ops.graph import Graph
from glass_tpu_torch.ops.labeling import max_zero_one
from glass_tpu_torch.train.metrics import device_metric_counts, score_from_counts
from glass_tpu_torch.train.schedule import PlateauState, plateau_init, plateau_step
from glass_tpu_torch.utils.graphs import (InferencePrograms, TrainingStep,
                                          on_stream)
from glass_tpu_torch.utils.profiling import span


def bce_with_logits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """BCEWithLogitsLoss on flattened logits (reference: GLASSTest.py:57-58)."""
    return F.binary_cross_entropy_with_logits(
        logits.float().reshape(-1), y.float().reshape(-1))


def ce_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss (reference: GLASSTest.py:69)."""
    return F.cross_entropy(logits.float(), y.long())


LOSSES: dict[str, Callable] = {"bce": bce_with_logits, "ce": ce_loss}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    resi: float = 0.7  # plateau LR factor (reference: GLASSTest.py:214-216)
    min_lr: float = 5e-5
    batch_size: int = 64
    loss: str = "ce"  # "bce" | "ce"
    use_z: bool = True  # --use_maxzeroone
    plateau_patience: int = 10
    plateau_threshold: float = 1e-4


def set_lr(optimizer: torch.optim.Optimizer, lr) -> None:
    """Every parameter group's rate to ``lr``: written in place into a
    capturable optimizer's device-tensor rate, which captured steps
    read."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


def adam(params, lr: float, device: torch.device) -> torch.optim.Adam:
    """``torch.optim.Adam`` with optax.adam's defaults (betas 0.9/0.999,
    eps 1e-8, no weight decay); on a CUDA card ``capturable``, its rate a
    device tensor (``set_lr`` rewrites it)."""
    capturable = device.type == "cuda"
    if capturable:
        lr = torch.tensor(lr, dtype=torch.float32, device=device)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


class EpochResult(NamedTuple):
    loss: float  # the epoch's mean loss (f32, the schedule's input)
    step_losses: np.ndarray  # (nb,) f32, one per step


class Trainer:
    """Trains and evaluates one (model, graph, x) triple on the model's
    device.

    ``model`` is a :class:`~glass_tpu_torch.nn.modules.GLASS` (any module
    with its ``forward(graph, x, pos, z, training=, generator=)``); graph,
    x and the model's parameters lie on one device. Call :meth:`init`
    before the first epoch. On a CUDA device each training step, and each
    evaluation, replays a captured CUDA graph."""

    def __init__(self, model: torch.nn.Module, graph: Graph, x: torch.Tensor,
                 cfg: TrainConfig):
        devices = {p.device for p in model.parameters()}
        devices |= {graph.device, x.device}
        if len(devices) != 1:
            raise ValueError(f"model, graph and x lie on several devices: "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()
        self.model = model
        self.graph = graph
        self.x = x
        self.cfg = cfg
        self.loss_fn = LOSSES[cfg.loss]
        self.optimizer: Optional[torch.optim.Adam] = None
        self.plateau: Optional[PlateauState] = None
        self.generator: Optional[torch.Generator] = None
        self._graphed = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._graphed
                        else None)
        self._steps: Optional[TrainingStep] = None
        self._eval_programs = InferencePrograms(self.device)
        self._epochs = 0  # epochs so far, the epoch spans' ident

    def init(self, seed: int) -> None:
        """A fresh Adam state, plateau state and dropout generator (on the
        model's device, seeded from ``seed``); a captured step and the eval
        programs are dropped."""
        self._eval_programs.clear()
        self.optimizer = adam(self.model.parameters(), self.cfg.lr,
                              self.device)
        self.plateau = plateau_init(self.cfg.lr)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._steps = TrainingStep(self._step, self.optimizer,
                                   self.generator)

    def _z(self, pos: torch.Tensor) -> Optional[torch.Tensor]:
        if not self.cfg.use_z:
            return None
        return max_zero_one(pos, self.graph.n_node)

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _step(self, pos: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One optimization step from cleared gradients; the loss."""
        logits = self.model(self.graph, self.x, pos, self._z(pos),
                            training=True, generator=self.generator)
        loss = self.loss_fn(logits, y)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _apply_lr(self) -> None:
        """Sets Adam's learning rate to the plateau state's."""
        if self.optimizer is None:
            raise RuntimeError("call Trainer.init(seed) before training")
        set_lr(self.optimizer, self.plateau.lr)

    def _epoch_span(self):
        """The next epoch's ``glass.train.epoch`` span."""
        self._epochs += 1
        return span("glass.train.epoch", self._epochs)

    def _batches(self, pos_b, y_b):
        """Host batches and labels on the device."""
        with span("glass.train.copy_in"):
            return self._to_device(pos_b), self._to_device(y_b)

    def _epoch(self, pos_b: torch.Tensor, y_b: torch.Tensor) -> EpochResult:
        """One epoch over device batches, then one plateau step on the
        epoch's mean loss (reference: GLASSTest.py:223-225)."""
        self._apply_lr()
        losses = torch.empty(pos_b.shape[0], dtype=torch.float32,
                             device=self.device)
        stream = self._stream if self._graphed else None
        with on_stream(stream):
            for i in range(pos_b.shape[0]):
                with span("glass.train.step"):
                    losses[i] = self._steps(pos_b[i], y_b[i], stream=stream)
            with span("glass.train.readback"):
                mean = np.float32(losses.mean().item())
                step_losses = losses.cpu().numpy()
        self.plateau = plateau_step(
            self.plateau, mean, factor=self.cfg.resi, min_lr=self.cfg.min_lr,
            patience=self.cfg.plateau_patience,
            threshold=self.cfg.plateau_threshold)
        return EpochResult(float(mean), step_losses)

    def train_epoch(self, pos_b, y_b) -> EpochResult:
        """One epoch over pre-batched (nb, B, ...) subgraphs and labels (from
        :func:`make_train_batches`), then one plateau step on the epoch's
        mean loss (reference: GLASSTest.py:223-225)."""
        with self._epoch_span():
            return self._epoch(*self._batches(pos_b, y_b))

    def train_epochs(self, pos_bs, y_bs) -> np.ndarray:
        """K epochs over (K, nb, B, ...) batches, the plateau advanced after
        each: the math of K :meth:`train_epoch` calls
        (``glass_tpu/train/loop.py:170-218``). Returns the (K,) f32 epoch
        mean losses."""
        pos_bs, y_bs = self._batches(pos_bs, y_bs)
        losses = []
        for p, y in zip(pos_bs, y_bs):
            with self._epoch_span():
                losses.append(self._epoch(p, y).loss)
        return np.asarray(losses, dtype=np.float32)

    def load_run_state(self, path, *, np_rng) -> dict:
        """Restores a run state that
        :func:`~glass_tpu_torch.utils.checkpoint.save_run_state` wrote, in
        place (``np_rng`` too), and returns its counters (epoch, val_score,
        tst_best, early_stop). The optimizer's state tensors are new ones,
        so the next step, and each eval program, is captured anew."""
        from glass_tpu_torch.utils.checkpoint import load_run_state

        if self._steps is not None:
            self._steps.graph = None
        self._eval_programs.clear()
        self.plateau, meta = load_run_state(
            path, model=self.model, optimizer=self.optimizer,
            generator=self.generator, np_rng=np_rng)
        return meta

    def _forward_batches(self, pos_b: torch.Tensor) -> torch.Tensor:
        """(nb, B, C) eval logits of (nb, B, L) device batches: dropout
        off, no generator."""
        return torch.stack([self.model(self.graph, self.x, pos, self._z(pos))
                            for pos in pos_b])

    def _batch_counts(self, pos_b, y_pad, mask) -> torch.Tensor:
        """The (TP, FP, FN) int32 counts of eval batches, on the device."""
        return device_metric_counts(self._forward_batches(pos_b), y_pad, mask,
                                    self.cfg.loss == "bce")

    def _eval_program(self, fn, *inputs: torch.Tensor):
        """``fn(*inputs)`` through the eval program of the inputs' shapes
        (captured and replayed on the card unless ``_graphed`` is cleared);
        the result is valid until the next evaluation."""
        key = (fn.__name__,) + tuple((tuple(t.shape), t.dtype)
                                     for t in inputs)
        return self._eval_programs(key, fn, inputs,
                                   self._stream if self._graphed else None)

    def _eval_logits(self, pos_b) -> torch.Tensor:
        return self._eval_program(self._forward_batches,
                                  self._to_device(pos_b))  # (nb, B, C)

    def evaluate(self, pos_b, n_real: int) -> np.ndarray:
        """Host logits of the first ``n_real`` samples of eval batches from
        :func:`make_eval_batches`."""
        logits = self._eval_logits(pos_b).cpu().numpy()
        return logits.reshape(-1, logits.shape[-1])[:n_real]

    def evaluate_score(self, pos_b, y_pad, mask) -> float:
        """Micro-F1 with the counts taken on the device inside the eval
        program (one (3,) readback); ``y_pad``/``mask`` from
        ``metrics.pad_eval_labels``."""
        counts = self._eval_program(self._batch_counts,
                                    *map(self._to_device, (pos_b, y_pad, mask)))
        return score_from_counts(counts.cpu().numpy())


def make_train_batches(rng: np.random.Generator, pos: np.ndarray,
                       y: np.ndarray, batch_size: int):
    """Shuffled, drop_last batching of the subgraph set (reference:
    GLASSTest.py:108-116). Copy of ``glass_tpu.train.loop``'s."""
    n = pos.shape[0]
    nb = n // batch_size
    if nb == 0:
        raise ValueError(f"batch_size {batch_size} > split size {n}")
    perm = rng.permutation(n)[: nb * batch_size].reshape(nb, batch_size)
    return pos[perm], y[perm]


def make_eval_batches(pos: np.ndarray, y: np.ndarray, batch_size: int,
                      rng: Optional[np.random.Generator] = None):
    """All samples, the last batch right-padded with all(-1) pos rows (inert
    for labeling and pooling); shuffled (and ``y`` permuted alike) when
    ``rng`` is given, as the reference's eval loaders are. Copy of
    ``glass_tpu.train.loop``'s."""
    n = pos.shape[0]
    if rng is not None:
        perm = rng.permutation(n)
        pos, y = pos[perm], y[perm]
    nb = -(-n // batch_size)
    pad = nb * batch_size - n
    pos_p = np.concatenate(
        [pos, np.full((pad,) + pos.shape[1:], -1, dtype=pos.dtype)])
    return pos_p.reshape(nb, batch_size, -1), y, n

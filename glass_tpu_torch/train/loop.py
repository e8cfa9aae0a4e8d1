"""Training and evaluation of GLASS (counterpart of
``glass_tpu/train/loop.py``).

Per step, as the JAX epoch program does it: the batch's zero-one labels
(``max_zero_one``), the whole-graph GLASS forward with dropout on, the loss,
the backward pass (every block-sparse SpMM's backward is its kernel over the
transposed layout) and an Adam step. The learning rate comes from the
plateau state at the start of each epoch, and the schedule advances on the
epoch's mean loss. PyTorch runs eagerly: where JAX scans an epoch in one
program, this loop launches each step's work from the host and reads the
losses back once per epoch.

Adam is ``torch.optim.Adam`` with optax.adam's defaults (betas 0.9/0.999,
eps 1e-8, no weight decay). Dropout masks come from a ``torch.Generator``
on the model's device, seeded by :meth:`Trainer.init`; the stream differs
from the TPU's (ROADMAP Queue 1 item 3).
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


class EpochResult(NamedTuple):
    loss: float  # the epoch's mean loss (f32, the schedule's input)
    step_losses: np.ndarray  # (nb,) f32, one per step


class Trainer:
    """Trains and evaluates one (model, graph, x) triple on the model's
    device.

    ``model`` is a :class:`~glass_tpu_torch.nn.modules.GLASS` (any module
    with its ``forward(graph, x, pos, z, training=, generator=)``); graph,
    x and the model's parameters lie on one device. Call :meth:`init`
    before the first epoch."""

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

    def init(self, seed: int) -> None:
        """A fresh Adam state, plateau state and dropout generator (on the
        model's device, seeded from ``seed``)."""
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.cfg.lr, betas=(0.9, 0.999),
            eps=1e-8)
        self.plateau = plateau_init(self.cfg.lr)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _z(self, pos: torch.Tensor) -> Optional[torch.Tensor]:
        if not self.cfg.use_z:
            return None
        return max_zero_one(pos, self.graph.n_node)

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def train_epoch(self, pos_b, y_b) -> EpochResult:
        """One epoch over pre-batched (nb, B, ...) subgraphs and labels (from
        :func:`make_train_batches`), then one plateau step on the epoch's
        mean loss (reference: GLASSTest.py:223-225)."""
        if self.optimizer is None:
            raise RuntimeError("call Trainer.init(seed) before training")
        for group in self.optimizer.param_groups:
            group["lr"] = float(self.plateau.lr)
        pos_b, y_b = self._to_device(pos_b), self._to_device(y_b)
        losses = []
        for pos, y in zip(pos_b, y_b):
            logits = self.model(self.graph, self.x, pos, self._z(pos),
                                training=True, generator=self.generator)
            loss = self.loss_fn(logits, y)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            losses.append(loss.detach())
        losses = torch.stack(losses)
        mean = np.float32(losses.mean().item())
        self.plateau = plateau_step(
            self.plateau, mean, factor=self.cfg.resi, min_lr=self.cfg.min_lr,
            patience=self.cfg.plateau_patience,
            threshold=self.cfg.plateau_threshold)
        return EpochResult(float(mean), losses.cpu().numpy())

    @torch.no_grad()
    def _eval_logits(self, pos_b) -> torch.Tensor:
        pos_b = self._to_device(pos_b)
        return torch.stack([self.model(self.graph, self.x, pos, self._z(pos))
                            for pos in pos_b])  # (nb, B, C)

    def evaluate(self, pos_b, n_real: int) -> np.ndarray:
        """Host logits of the first ``n_real`` samples of eval batches from
        :func:`make_eval_batches`."""
        logits = self._eval_logits(pos_b).cpu().numpy()
        return logits.reshape(-1, logits.shape[-1])[:n_real]

    def evaluate_score(self, pos_b, y_pad, mask) -> float:
        """Micro-F1 with the counts taken on the device (one (3,) readback);
        ``y_pad``/``mask`` from ``metrics.pad_eval_labels``."""
        counts = device_metric_counts(
            self._eval_logits(pos_b), self._to_device(y_pad),
            self._to_device(mask), self.cfg.loss == "bce")
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

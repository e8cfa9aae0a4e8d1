"""ReduceLROnPlateau as a pure state transition (counterpart of
``glass_tpu/train/schedule.py``).

Torch semantics (mode='min', threshold_mode='rel', cooldown=0), stepped on
the epoch's mean train loss:
  is_better  := loss < best * (1 - threshold)         threshold = 1e-4
  on better  : best = loss, num_bad = 0
  on worse   : num_bad += 1
  num_bad > patience (default 10): lr = max(lr * factor, min_lr), num_bad = 0

The arithmetic is numpy float32, as the JAX version's is, so that a loss at
the threshold falls the same way in both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PlateauState(NamedTuple):
    lr: np.float32  # current learning rate
    best: np.float32  # best loss seen
    num_bad: int  # epochs since the last improvement


def plateau_init(lr: float) -> PlateauState:
    return PlateauState(lr=np.float32(lr), best=np.float32(np.inf), num_bad=0)


def plateau_step(state: PlateauState, loss, factor: float,
                 min_lr: float = 5e-5, patience: int = 10,
                 threshold: float = 1e-4) -> PlateauState:
    loss = np.float32(loss)
    is_better = bool(loss < state.best * np.float32(1.0 - threshold))
    best = loss if is_better else state.best
    num_bad = 0 if is_better else state.num_bad + 1
    lr = state.lr
    if num_bad > patience:
        lr = np.maximum(state.lr * np.float32(factor), np.float32(min_lr))
        num_bad = 0
    return PlateauState(lr=np.float32(lr), best=np.float32(best),
                        num_bad=num_bad)

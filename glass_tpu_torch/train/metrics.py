"""Evaluation metrics (counterpart of ``glass_tpu/train/metrics.py``).

Micro-F1 in the three cases GLASS meets is a ratio of integer counts:

- multilabel (binary, C > 1): TP, FP and FN over all (sample, label) cells;
- single-logit binary (C == 1): micro-averaged over both classes, micro-F1
  is accuracy, counted as TP = correct and FP = FN = wrong;
- multiclass argmax: micro-F1 is accuracy, counted the same way.

So the host functions count in numpy (no sklearn) and the device path
counts on the card, and both divide 2 TP / (2 TP + FP + FN) in float64 on
the host, with 0 for an empty denominator (sklearn's zero_division=0).
"""

from __future__ import annotations

import numpy as np
import torch


def score_from_counts(counts) -> float:
    """Host-side float64 micro-F1 from (TP, FP, FN)."""
    tp, fp, fn = np.asarray(counts, dtype=np.int64)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0


def binary_f1(pred: np.ndarray, label: np.ndarray) -> float:
    """Micro-F1 of logits thresholded at 0; multilabel when C > 1
    (reference: impl/metrics.py:5-12)."""
    pred_b = np.asarray(pred) > 0
    label_b = np.asarray(label).reshape(pred_b.shape[0], -1) > 0.5
    if pred_b.shape[1] == 1:
        hit = int((pred_b == label_b).sum())
        wrong = pred_b.shape[0] - hit
        return score_from_counts((hit, wrong, wrong))
    return score_from_counts(((pred_b & label_b).sum(),
                              (pred_b & ~label_b).sum(),
                              (~pred_b & label_b).sum()))


def micro_f1(pred: np.ndarray, label: np.ndarray) -> float:
    """Multiclass micro-F1 over argmax, i.e. accuracy (reference:
    impl/metrics.py:15-20)."""
    hit = int((np.argmax(np.asarray(pred), axis=1) == np.asarray(label)).sum())
    wrong = len(label) - hit
    return score_from_counts((hit, wrong, wrong))


def device_metric_counts(logits: torch.Tensor, y_pad: torch.Tensor,
                         mask: torch.Tensor, binary: bool) -> torch.Tensor:
    """(TP, FP, FN) as an int32 tensor on the logits' device.

    Args:
      logits: (nb, B, C) model outputs (padded eval batches).
      y_pad:  (nb, B) integer labels (multiclass) or (nb, B) / (nb, B, L)
              binary/multilabel targets, zero-padded like the batches.
      mask:   (nb, B) bool, False on the right-padding rows.
      binary: True = threshold-at-0 semantics; False = argmax.
    """
    if binary and logits.shape[-1] > 1:
        pred = logits > 0
        yb = y_pad.reshape(pred.shape[0], pred.shape[1], -1) > 0.5
        m = mask[..., None]
        tp = (pred & yb & m).sum()
        fp = (pred & ~yb & m).sum()
        fn = (~pred & yb & m).sum()
        return torch.stack([tp, fp, fn]).to(torch.int32)
    if binary:  # single logit: thresholded accuracy
        pred = logits[..., 0] > 0
        hit = pred == (y_pad.reshape(pred.shape) > 0.5)
    else:  # multiclass: argmax accuracy
        hit = torch.argmax(logits, dim=-1) == y_pad
    correct = (hit & mask).sum()
    wrong = mask.sum() - correct
    return torch.stack([correct, wrong, wrong]).to(torch.int32)


def pad_eval_labels(y_p: np.ndarray, nb: int, batch_size: int):
    """(y_pad, mask) matching ``make_eval_batches``' right-padded layout:
    labels zero-padded to (nb, batch_size, ...), mask False on the padding
    rows."""
    n = y_p.shape[0]
    pad = nb * batch_size - n
    y_pad = np.concatenate(
        [y_p, np.zeros((pad,) + y_p.shape[1:], dtype=y_p.dtype)]
    ).reshape((nb, batch_size) + y_p.shape[1:])
    mask = (np.arange(nb * batch_size) < n).reshape(nb, batch_size)
    return y_pad, mask

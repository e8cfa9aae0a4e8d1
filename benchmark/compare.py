"""The numbers that decide ``correct``, each against its limit.

Training (the first three steps that set-up drives through the window's
own call): ``loss`` is the largest relative gap of a step's loss;
``grad`` the largest gap between the program's and the reference's norm
of a leaf's first gradient (the program's as Adam holds it after one
step); ``change`` the largest gap between the two norms of a leaf's
change over the three steps. A leaf's gap is measured against the larger
of the reference's norm of that leaf and of the median leaf. Leaves whose
first gradient in the reference is under a thousandth of the median
leaf's move under Adam by rounding alone, and are left out of
``change``.

Serving: ``logits`` is the largest gap between a served logit and the
reference's, over a sample of the requests the window served, against
the largest reference logit of the sample.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import numpy as np

TINY_GRAD = 1e-3  # of the median leaf's first gradient: left out of change


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               leaves) -> float:
    leaves = list(leaves)
    scale = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], scale, 1e-30)
               for k in leaves)


def moving_leaves(grad_norms: Dict[str, float]) -> List[str]:
    """The leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's."""
    med = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= TINY_GRAD * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (a float a step), ``grad_norms``
    and ``change_norms`` (a float a leaf)."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides ran different numbers of steps")
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    return dict(loss=loss,
                grad=_leaf_gaps(prog["grad_norms"], g, g),
                change=_leaf_gaps(prog["change_norms"], ref["change_norms"],
                                  moving_leaves(g)))


def serve_numbers(prog: List[np.ndarray], ref: List[np.ndarray]
                  ) -> Dict[str, float]:
    """Logits of the same sampled requests, in the same order."""
    if len(prog) != len(ref):
        raise ValueError("the two sides scored different request samples")
    p = np.concatenate([np.asarray(a, np.float64).ravel() for a in prog])
    r = np.concatenate([np.asarray(a, np.float64).ravel() for a in ref])
    if p.shape != r.shape or not np.isfinite(p).all():
        return dict(logits=float("inf"))
    return dict(logits=float(np.abs(p - r).max() / max(np.abs(r).max(),
                                                        1e-30)))


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {value, limit}}). A number
    that is not finite fails."""
    missing = set(numbers) ^ set(limits)
    if missing:
        raise ValueError(f"numbers and limits differ in {sorted(missing)}")
    checks = {k: dict(value=float(v), limit=float(limits[k]))
              for k, v in numbers.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks

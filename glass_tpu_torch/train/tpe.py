"""Tree-structured Parzen Estimator (TPE) for categorical search spaces
(a copy of ``glass_tpu/train/tpe.py``, which the port does not import).

The reference runs its SSL hyperparameter search with optuna's default
sampler — TPE — backed by resumable sqlite storage (reference:
GNNEmb.py:194-199). optuna is not installable in every deployment, so this
is a small, dependency-free TPE for the categorical spaces the framework
searches (train/ssl.py::SEARCH_SPACE), used by ``run_hpo`` as the default
no-optuna sampler with the same resumable-study contract.

Algorithm (Bergstra et al., "Algorithms for Hyper-Parameter Optimization",
NeurIPS 2011, univariate categorical form):

1. The first ``n_startup`` trials are random (seeded).
2. Afterwards, completed trials are split by score into a *good* set (the
   top ``gamma(n)`` trials) and a *bad* set (the rest).
3. For each parameter independently, two smoothed categorical densities are
   built — l(x) from the good set, g(x) from the bad set (counts plus a
   uniform prior weight, normalized).
4. ``n_candidates`` values are drawn from l and the one maximizing the
   acquisition ratio l(x)/g(x) is chosen (the EI-equivalent for TPE).

Determinism/resume: the RNG is seeded per (sampler seed, trial index), and
the suggestion is otherwise a pure function of the completed-trial history —
so a study resumed from its persisted trials reproduces exactly the
suggestions an uninterrupted run would have made.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def default_gamma(n: int) -> int:
    """Size of the 'good' split: ceil(10% of n), capped at 25 (the standard
    TPE schedule)."""
    return max(1, min(int(np.ceil(0.1 * n)), 25))


class TPESampler:
    """Categorical TPE over a ``{name: [choices...]}`` space.

    ``suggest(space, history, trial_idx)`` returns a params dict;
    ``history`` is a list of ``{"params": {...}, "score": float}`` for
    completed trials (higher score = better).
    """

    def __init__(
        self,
        seed: int = 0,
        n_startup: int = 10,
        n_candidates: int = 24,
        prior_weight: float = 1.0,
    ):
        if n_startup < 1 or n_candidates < 1 or prior_weight <= 0:
            raise ValueError("n_startup/n_candidates >= 1, prior_weight > 0")
        self.seed = seed
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.prior_weight = prior_weight

    def _rng(self, trial_idx: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, trial_idx])

    def suggest(
        self,
        space: Dict[str, Sequence],
        history: List[dict],
        trial_idx: int,
    ) -> dict:
        rng = self._rng(trial_idx)
        if len(history) < self.n_startup:
            return {
                name: choices[rng.integers(len(choices))]
                for name, choices in space.items()
            }
        scores = np.asarray([t["score"] for t in history], dtype=np.float64)
        order = np.argsort(-scores, kind="stable")
        n_good = default_gamma(len(history))
        good = [history[i]["params"] for i in order[:n_good]]
        bad = [history[i]["params"] for i in order[n_good:]]
        params = {}
        for name, choices in space.items():
            idx = {v: i for i, v in enumerate(choices)}

            def density(trials) -> np.ndarray:
                w = np.full(len(choices), self.prior_weight, dtype=np.float64)
                for t in trials:
                    # unknown values (space changed between runs) are skipped
                    # rather than crashing a resumed study
                    i = idx.get(t.get(name))
                    if i is not None:
                        w[i] += 1.0
                return w / w.sum()

            l, g = density(good), density(bad)
            cand = rng.choice(len(choices), size=self.n_candidates, p=l)
            pick = cand[np.argmax(l[cand] / g[cand])]
            params[name] = choices[int(pick)]
        return params

"""Minimal optuna-compatible study API over sqlite, dependency-free (a copy
of ``glass_tpu/compat/optuna_lite.py`` on the port's own TPE, which the
port does not import).

The reference persists its SSL hyperparameter search as a resumable optuna
study in sqlite (``optuna.create_study(storage="sqlite:///Emb/<name>.db",
load_if_exists=True)`` — reference GNNEmb.py:194-199). optuna itself is not
installable in every deployment, but sqlite3 is stdlib — this module
implements the slice of the optuna API that contract needs, and the port's
``run_hpo`` always runs on it, so a study's draws and file are the same
whether or not optuna is installed:

- :func:`create_study` (direction, storage="sqlite:///...", study_name,
  load_if_exists, sampler)
- ``Study.optimize(func, n_trials)`` / ``best_params`` / ``best_value`` /
  ``trials``
- ``Trial.suggest_categorical`` / ``suggest_int`` / ``suggest_float``

Samplers: :class:`LiteTPESampler` (the in-repo TPE, train/tpe.py — the
same algorithm family as optuna's default) and :class:`LiteRandomSampler`.
Both draw each parameter as a pure function of (seed, trial number,
parameter name, completed-trial history), so a study resumed from its
sqlite file continues with exactly the suggestions an uninterrupted run
would have made — no rng-stream fast-forwarding needed.

``suggest_float``/``suggest_int`` discretize onto a grid (``step`` when
given, else 17 points) — the categorical TPE then searches that grid. The
framework's own space (train/ssl.py::SEARCH_SPACE) is fully categorical.
"""

from __future__ import annotations

import contextlib
import json
import sqlite3
import zlib
from pathlib import Path
from typing import Callable, List, Optional, Sequence


def _name_seed(seed: int, name: str) -> int:
    return (seed * 1_000_003 + zlib.crc32(name.encode())) & 0x7FFFFFFF


class LiteRandomSampler:
    def __init__(self, seed: int = 0):
        self.seed = seed

    def pick(self, name, choices, history, number, direction="maximize"):
        import numpy as np

        rng = np.random.default_rng([_name_seed(self.seed, name), number])
        return choices[int(rng.integers(len(choices)))]


class LiteTPESampler:
    """Per-parameter TPE backed by train/tpe.py (univariate categorical)."""

    def __init__(self, seed: int = 0, n_startup: int = 10):
        self.seed = seed
        self.n_startup = n_startup

    def pick(self, name, choices, history, number, direction="maximize"):
        from glass_tpu_torch.train.tpe import TPESampler

        tpe = TPESampler(seed=_name_seed(self.seed, name),
                         n_startup=self.n_startup)
        sign = 1.0 if direction == "maximize" else -1.0  # TPE maximizes
        hist = [{"params": t.params, "score": sign * t.value}
                for t in history if t.value is not None]
        return tpe.suggest({name: list(choices)}, hist, number)[name]


class FrozenTrial:
    def __init__(self, number: int, params: dict, value: Optional[float]):
        self.number = number
        self.params = params
        self.value = value


class Trial:
    """Live trial: accumulates params through suggest_* calls."""

    def __init__(self, study: "Study", number: int):
        self._study = study
        self.number = number
        self.params: dict = {}

    def _suggest(self, name: str, choices: Sequence):
        if name in self.params:
            return self.params[name]
        v = self._study._sampler.pick(
            name, list(choices), self._study.trials, self.number,
            direction=self._study.direction,
        )
        self.params[name] = v
        return v

    def suggest_categorical(self, name: str, choices: Sequence):
        return self._suggest(name, choices)

    def suggest_int(self, name: str, low: int, high: int, step: int = 1):
        return int(self._suggest(name, list(range(low, high + 1, step))))

    def suggest_float(self, name: str, low: float, high: float,
                      step: Optional[float] = None):
        import numpy as np

        if step is not None:
            grid = list(np.arange(low, high + step / 2, step))
        else:
            grid = list(np.linspace(low, high, 17))
        return float(self._suggest(name, [float(g) for g in grid]))

    # optuna parity aliases (pre-3.0 API names the reference era used)
    suggest_uniform = suggest_float


class Study:
    def __init__(self, name: str, direction: str,
                 db_path: Optional[Path], sampler):
        if direction not in ("maximize", "minimize"):
            raise ValueError(f"unknown direction {direction!r}")
        self.study_name = name
        self.direction = direction
        self._db_path = db_path
        self._sampler = sampler
        self.trials: List[FrozenTrial] = []
        if db_path is not None:
            self._init_db()
            self._load()

    # ---------------------------------------------------------- sqlite
    def _conn(self):
        # contextlib.closing: `with sqlite3.connect(...)` alone only
        # commits/rolls back the transaction — it does NOT close the handle,
        # so long studies would leak one fd per trial persist.
        self._db_path.parent.mkdir(parents=True, exist_ok=True)
        return contextlib.closing(sqlite3.connect(self._db_path))

    def _init_db(self):
        with self._conn() as conn, conn as c:
            c.execute(
                "CREATE TABLE IF NOT EXISTS studies ("
                "name TEXT PRIMARY KEY, direction TEXT)"
            )
            c.execute(
                "CREATE TABLE IF NOT EXISTS trials ("
                "study TEXT, number INTEGER, value REAL, params TEXT, "
                "PRIMARY KEY (study, number))"
            )
            row = c.execute("SELECT direction FROM studies WHERE name=?",
                            (self.study_name,)).fetchone()
            if row is None:
                c.execute("INSERT INTO studies VALUES (?, ?)",
                          (self.study_name, self.direction))
            elif row[0] != self.direction:
                raise ValueError(
                    f"study {self.study_name!r} exists with direction "
                    f"{row[0]!r}, requested {self.direction!r}"
                )

    def _load(self):
        with self._conn() as conn, conn as c:
            rows = c.execute(
                "SELECT number, value, params FROM trials WHERE study=? "
                "ORDER BY number", (self.study_name,)
            ).fetchall()
        self.trials = [
            FrozenTrial(n, json.loads(p), v) for n, v, p in rows
        ]

    def _persist(self, t: FrozenTrial):
        if self._db_path is None:
            return
        with self._conn() as conn, conn as c:  # one txn per trial: kill-safe
            c.execute(
                "INSERT OR REPLACE INTO trials VALUES (?, ?, ?, ?)",
                (self.study_name, t.number, t.value, json.dumps(t.params)),
            )

    # ---------------------------------------------------------- public
    def optimize(self, func: Callable[[Trial], float], n_trials: int):
        start = (max((t.number for t in self.trials), default=-1)) + 1
        for number in range(start, start + n_trials):
            trial = Trial(self, number)
            value = float(func(trial))
            frozen = FrozenTrial(number, dict(trial.params), value)
            self.trials.append(frozen)
            self._persist(frozen)

    def _best(self) -> FrozenTrial:
        done = [t for t in self.trials if t.value is not None]
        if not done:
            raise ValueError("no completed trials")
        key = (max if self.direction == "maximize" else min)
        return key(done, key=lambda t: t.value)

    @property
    def best_params(self) -> dict:
        return dict(self._best().params)

    @property
    def best_value(self) -> float:
        return self._best().value


def create_study(direction: str = "minimize", storage: Optional[str] = None,
                 study_name: str = "study", load_if_exists: bool = False,
                 sampler=None) -> Study:
    db_path = None
    if storage is not None:
        db_path = Path(str(storage).replace("sqlite:///", ""))
        if db_path.exists() and not load_if_exists:
            # optuna raises DuplicatedStudyError only if the study NAME
            # exists; mirror per-name semantics
            with contextlib.closing(sqlite3.connect(db_path)) as conn, conn as c:
                try:
                    hit = c.execute(
                        "SELECT 1 FROM studies WHERE name=?", (study_name,)
                    ).fetchone()
                except sqlite3.OperationalError:
                    hit = None
            if hit:
                raise ValueError(
                    f"study {study_name!r} already exists "
                    "(pass load_if_exists=True)"
                )
    return Study(study_name, direction, db_path,
                 sampler if sampler is not None else LiteTPESampler())

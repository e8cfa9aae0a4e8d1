"""Training throughput counters (counterpart of
``glass_tpu/utils/profiling.py::StepMeter``).

The JAX module's ``trace`` (a ``jax.profiler`` trace) and ``nan_check_mode``
(``jax_debug_nans``) are JAX tools; their counterparts (``torch.profiler``,
``torch.autograd.detect_anomaly``) are listed in ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class StepMeter:
    """Accumulates training throughput. Call ``tick`` after each (blocking)
    step with the work it performed."""

    edges_per_step: int = 0
    subgraphs_per_step: int = 0
    steps: int = 0
    _t0: Optional[float] = None
    _elapsed: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def tick(self, steps: int = 1) -> None:
        now = time.perf_counter()
        if self._t0 is not None:
            self._elapsed += now - self._t0
        self._t0 = now
        self.steps += steps

    @property
    def seconds(self) -> float:
        return self._elapsed

    @property
    def steps_per_s(self) -> float:
        return self.steps / self._elapsed if self._elapsed else 0.0

    @property
    def edges_per_s(self) -> float:
        return self.steps_per_s * self.edges_per_step

    @property
    def subgraphs_per_s(self) -> float:
        return self.steps_per_s * self.subgraphs_per_step

    def summary(self) -> str:
        return (
            f"{self.steps} steps in {self._elapsed:.2f}s: "
            f"{self.steps_per_s:.1f} steps/s, "
            f"{self.edges_per_s / 1e6:.1f}M edges/s, "
            f"{self.subgraphs_per_s:.1f} subgraphs/s"
        )

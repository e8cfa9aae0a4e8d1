"""Observability: throughput counters, profiler traces, NaN-check mode
(counterpart of ``glass_tpu/utils/profiling.py``).

- :class:`StepMeter` accumulates steps/edges/subgraphs per second;
- :func:`trace` wraps a block in a ``torch.profiler`` trace (CPU, and the
  card's kernels where there is one) and writes it as a Chrome trace
  (chrome://tracing, Perfetto or TensorBoard read it);
- :func:`nan_check_mode` raises at the first op that makes a NaN, forward
  or backward, the counterpart of ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from pathlib import Path
from typing import Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


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


@contextlib.contextmanager
def trace(name: str, log_dir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` trace around a block, marked ``name``, written to
    ``log_dir`` (default: ``glass_tpu_torch_trace`` in the temp directory)
    as ``{name}.{pid}.{time_ns}.pt.trace.json``. The block's CUDA work is
    waited for before the trace closes."""
    log_dir = Path(log_dir or Path(tempfile.gettempdir())
                   / "glass_tpu_torch_trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(
        log_dir / f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


# ops whose output is memory not yet written, where any bits may lie
_UNINITIALIZED = {getattr(torch.ops.aten, name) for name in (
    "empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
    "new_empty_strided") if hasattr(torch.ops.aten, name)}


class _RaiseOnNaN(TorchDispatchMode):
    """Raises ``FloatingPointError`` naming the op when any floating output
    of an op (but an allocation) holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNINITIALIZED:
            return out
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def nan_check_mode() -> Iterator[None]:
    """Within the block, any op that makes a NaN raises
    ``FloatingPointError`` naming the op, as ``jax_debug_nans`` raises at
    the offending primitive, forward and backward (the autograd engine
    carries the dispatch mode into the backward's ops). Besides,
    ``torch.autograd.detect_anomaly(check_nan=True)`` checks every backward
    function's outputs (a ``RuntimeError`` naming it) and records the
    forward's stack for it. Each output is checked as it is made, which
    waits for the card. Both switches are restored on exit."""
    with torch.autograd.detect_anomaly(check_nan=True), _RaiseOnNaN():
        yield

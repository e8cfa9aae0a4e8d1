"""Observability: throughput counters, profiler traces, the program's own
spans and counters, NaN-check mode (counterpart of
``glass_tpu/utils/profiling.py``).

- :class:`StepMeter` accumulates steps/edges/subgraphs per second;
- :func:`trace` wraps a block in a ``torch.profiler`` trace (CPU, and the
  card's kernels where there is one) and writes it as a Chrome trace
  (chrome://tracing, Perfetto or TensorBoard read it);
- :func:`span` and :func:`count` mark the program's layer boundaries
  (``glass.serve.*`` in ``Predictor``, ``glass.train.*`` in ``Trainer``,
  ``glass.capture`` around every capture). They record only while a
  ``torch.profiler`` profile records (:func:`trace`, or the benchmark's
  traced window); otherwise ``span`` is one flag check that returns a
  shared no-op context. While recording, a span is a profiler event
  (``ident`` in its args, which the trace shows with ``record_shapes``)
  nested under whatever the caller opened, and an entry of a table kept
  in this module: count, total and self seconds (total less the child
  spans' time) and the enclosing span's name. :func:`span_table` reads
  the table, :func:`reset_spans` clears it. The table is the process's,
  not an object's, so that it outlives the program it describes: a
  reader (``benchmark/metrics/``) reads it after the program is freed.
- :func:`nan_check_mode` raises at the first op that makes a NaN, forward
  or backward, the counterpart of ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler
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


def _event(name: str, ident: Optional[int]):
    """The profiler event a recording span emits: the C++ binding of the
    profiler's RecordFunction, several times cheaper under a profile than
    ``record_function``'s Python class."""
    if ident is None:  # the binding takes a list and a dict, never None
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, [], {"ident": int(ident)})


_OFF = contextlib.nullcontext()  # every span's while nothing records
_LOCK = threading.Lock()
_TABLE: Dict[str, dict] = {}  # name -> the span's or counter's entry
_OPEN = threading.local()  # .stack: this thread's open spans


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class _Span:
    """A recording span: a profiler event and the table's entry."""

    __slots__ = ("name", "event", "t0", "child_ns")

    def __init__(self, name: str, ident: Optional[int]):
        self.name = name
        self.event = _event(name, ident)
        self.child_ns = 0

    def __enter__(self):
        self.event.__enter__()
        _stack().append(self)
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc) -> None:
        took = time.perf_counter_ns() - self.t0
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += took
        with _LOCK:
            e = _TABLE.get(self.name)
            if e is None:
                e = _TABLE[self.name] = dict(
                    count=0, total_s=0.0, self_s=0.0,
                    parent=stack[-1].name if stack else None)
            e["count"] += 1
            e["total_s"] += took / 1e9
            e["self_s"] += (took - self.child_ns) / 1e9
        self.event.__exit__(*exc)


def recording() -> bool:
    """Whether a ``torch.profiler`` profile records, and so spans and
    counters with it."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, ident: Optional[int] = None):
    """A context around one step of the program, recorded only while a
    profiler records (module docstring); ``ident`` tells one request or
    epoch from the next in the trace."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, ident)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` while a profiler records; its
    entry holds the sum (``value``), the number of adds (``count``) and
    the span open at the first add (``parent``)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _stack()
    parent = stack[-1].name if stack else None
    with _LOCK:
        e = _TABLE.get(name)
        if e is None:
            e = _TABLE[name] = dict(count=0, value=0, parent=parent)
        e["count"] += 1
        e["value"] += n


def span_table() -> Dict[str, dict]:
    """A copy of the table: for each span's name ``count``, ``total_s``,
    ``self_s`` and ``parent``; for each counter ``count``, ``value`` and
    ``parent``."""
    with _LOCK:
        return {k: dict(v) for k, v in _TABLE.items()}


def reset_spans() -> None:
    """Clears the table."""
    with _LOCK:
        _TABLE.clear()


@contextlib.contextmanager
def trace(name: str, log_dir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` trace around a block, marked ``name``, written to
    ``log_dir`` (default: ``glass_tpu_torch_trace`` in the temp directory)
    as ``{name}.{pid}.{time_ns}.pt.trace.json``, with the ops' input shapes
    and the program's spans and their idents; the span table is cleared
    first, so that after the block it holds the block's spans. The block's
    CUDA work is waited for before the trace closes."""
    log_dir = Path(log_dir or Path(tempfile.gettempdir())
                   / "glass_tpu_torch_trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    reset_spans()
    with torch.profiler.profile(activities=activities,
                                record_shapes=True) as prof:
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

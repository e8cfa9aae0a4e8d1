"""Captured programs: the port's counterpart of the JAX package's compiled
programs. A training step (``glass_tpu/train/loop.py``'s epoch scan,
``glass_tpu/train/ssl.py:102-113``, ``glass_tpu/train/seg_protocol.py:80-102``)
is a :class:`TrainingStep`; a forward, one per input shape
(``glass_tpu/serve.py:63-73`` jit-compiles the forward once per serving
bucket; ``glass_tpu/train/loop.py:226-258`` runs every eval batch in one
jitted scan), an :class:`InferencePrograms` entry.

A :class:`TrainingStep` runs ``fn`` (forward, backward and the optimizer's
step, from cleared gradients) once a call. On a CUDA stream the first call
of an input shape runs eagerly on it and is a real step; the capture into
a ``torch.cuda.CUDAGraph`` (:class:`StepGraph`: static copies of the
inputs, the dropout generator registered) follows and runs nothing; later
calls copy their inputs into the static buffers and replay. Without a
stream (the CPU, or an owner's private ``_graphed`` flag cleared to
compare with the eager path) every call runs ``fn`` eagerly. The
optimizer must be capturable on the card (``torch.optim.Adam(...,
capturable=True)`` with a device-tensor rate, rewritten in place).

An :class:`InferencePrograms` cache holds one no-grad program per key (an
input shape). On a CUDA card the first call of a key runs the function
eagerly on the caller's stream and returns its real result (it also builds
the kernels' libraries and the fused norm's per-stream workspace outside
any capture); the capture follows and runs nothing. Later calls of the key
copy their inputs into the program's static buffers on that stream and
replay. Without a stream every call runs the function eagerly; the cache
still keeps one entry per key.

Kernel wrappers count a launch when they are called, so a captured step
or program counts its launches once, at its capture, and its replays
count nothing (the kernels' device counters count every replay). A failed
capture raises; nothing falls back to the eager function.

The programs of one cache share one memory pool
(``torch.cuda.graph_pool_handle``), so a cache holds about the memory of its
largest program rather than the sum of all of them. That is safe under the
cache's rules: every program keeps its static outputs alive, so a later
capture never takes their memory; all programs run on one stream, so two
never run at once; and a call's result (a program's static outputs, which
the next replay of a program that shares their memory may overwrite) is
read before the owner's next call.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Hashable, Optional, Sequence

import torch


@contextlib.contextmanager
def on_stream(stream: Optional[torch.cuda.Stream]):
    """The block's work on ``stream``, after the current stream's work
    before it and before the current stream's work after it; without a
    stream, the block on the current stream."""
    if stream is None:
        yield
        return
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


@contextlib.contextmanager
def capturing(graph: torch.cuda.CUDAGraph, stream: torch.cuda.Stream,
              pool=None):
    """``torch.cuda.graph(graph, pool, stream)`` with Python's cyclic
    garbage collector held off until the capture ends: a collection frees
    garbage of any age, and a CUDA graph freed while a stream captures
    (``cudaGraphExecDestroy``) invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """One captured training step: ``fn(*inputs)`` (forward, backward and
    the optimizer's step; returns the detached loss) in a CUDA graph,
    reading static copies of ``example``, from cleared gradients, with
    ``generator`` (the dropout masks') registered, so that every replay
    draws the masks the same step draws eagerly. The capture runs
    nothing."""

    def __init__(self, fn: Callable, example: Sequence[torch.Tensor],
                 optimizer: torch.optim.Optimizer,
                 generator: Optional[torch.Generator],
                 stream: torch.cuda.Stream):
        self.graph = torch.cuda.CUDAGraph()
        self.inputs = tuple(t.clone() for t in example)
        optimizer.zero_grad(set_to_none=True)
        if generator is not None:
            self.graph.register_generator_state(generator)
        with capturing(self.graph, stream):
            self.loss = fn(*self.inputs)

    def takes(self, *inputs: torch.Tensor) -> bool:
        return all(a.shape == b.shape and a.dtype == b.dtype
                   for a, b in zip(self.inputs, inputs))

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        """Copies ``inputs`` into the static buffers and replays; the
        static loss."""
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        self.graph.replay()
        return self.loss


class TrainingStep:
    """``fn`` once a call, captured on the card (module docstring).
    ``graph`` is the captured step (None before the first call on a
    stream); an owner whose optimizer state or model changes sets it to
    None, and the next call captures anew."""

    def __init__(self, fn: Callable, optimizer: torch.optim.Optimizer,
                 generator: Optional[torch.Generator] = None):
        self.fn = fn
        self.optimizer = optimizer
        self.generator = generator
        self.graph: Optional[StepGraph] = None

    def __call__(self, *inputs: torch.Tensor,
                 stream: Optional[torch.cuda.Stream] = None) -> torch.Tensor:
        """One step on ``inputs``; its loss on the device (a captured
        step's static loss: read it before the next call). With a
        ``stream``, call inside ``on_stream(stream)``."""
        if (stream is not None and self.graph is not None
                and self.graph.takes(*inputs)):
            return self.graph(*inputs)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.fn(*inputs)  # a real step, eager
        if stream is not None:
            self.graph = StepGraph(self.fn, inputs, self.optimizer,
                                   self.generator, stream)
        return loss


class InferenceProgram:
    """One no-grad program for one input shape: with a CUDA stream, a
    captured graph with its static input buffers and static outputs;
    without one, the key's record only (the cache runs the function). It
    keeps no reference to the function (a bound method of its owner, which
    holds the program), so no reference cycle keeps a dropped owner's
    graphs alive until a collection."""

    def __init__(self, fn: Callable, example: Sequence[torch.Tensor],
                 stream: Optional[torch.cuda.Stream] = None, pool=None):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: tuple = ()
        self.outputs = None
        if stream is not None:
            self.inputs = tuple(t.clone() for t in example)
            self.graph = torch.cuda.CUDAGraph()
            with capturing(self.graph, stream, pool):
                self.outputs = fn(*self.inputs)

    def __call__(self, *inputs: torch.Tensor):
        """Copies ``inputs`` into the static buffers and replays."""
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t, non_blocking=True)
        self.graph.replay()
        return self.outputs


class InferencePrograms:
    """One :class:`InferenceProgram` per key, on ``device``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.programs: Dict[Hashable, InferenceProgram] = {}
        self._pool = None

    def clear(self) -> None:
        """Drops every program (and, with the last graph, its pool)."""
        self.programs.clear()
        self._pool = None

    @torch.no_grad()
    def __call__(self, key: Hashable, fn: Callable,
                 inputs: Sequence[torch.Tensor],
                 stream: Optional[torch.cuda.Stream] = None):
        """``fn(*inputs)`` through ``key``'s program: with a CUDA
        ``stream``, the first call of the key runs eagerly on it and
        captures the program after, and later calls replay; without one,
        eagerly on the current stream. ``inputs`` may lie on the host (a
        pinned buffer copies asynchronously, in the stream's order) and
        always have the shapes and dtypes that ``key`` stands for. The
        result is valid until the next call."""
        prog = self.programs.get(key)
        if stream is None:
            if prog is None:
                self.programs[key] = InferenceProgram(fn, inputs)
            return fn(*(t.to(self.device, non_blocking=True) for t in inputs))
        with on_stream(stream):
            if prog is None or prog.graph is None:
                dev = [t.to(self.device, non_blocking=True) for t in inputs]
                out = fn(*dev)  # a real call, eager
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                self.programs[key] = InferenceProgram(fn, dev, stream,
                                                      self._pool)
            else:
                out = prog(*inputs)
        return out

"""The traced window: ``torch.profiler`` over the window, its Chrome trace
read back and reduced to what the per-layer metrics and the breakdown
read.

Device time is every ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` event.
The window is the benchmark's own ``bench.window`` annotation on the host,
on the clock the profiler aligns the device's events to. Idle gaps are the
window's stretches with no device event, each labelled by what the host
thread that opened the window was inside at the gap's middle: the
outermost ``bench.*`` span and the innermost operation or runtime call.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160


def span(name: str):
    """A host span the trace records (``bench.<name>``)."""
    return torch.profiler.record_function(f"bench.{name}")


@contextlib.contextmanager
def traced(path: Path):
    """Profiles the block (host and device) and writes its Chrome trace to
    ``path``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


def load_events(path: Path) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _labels(host: List[dict], mids: List[float]) -> List[str]:
    """For each time in ``mids`` (ascending), the outermost ``bench.`` span
    and the innermost event of ``host`` (one thread's, nested) around it."""
    host = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = [], [], 0
    for mid in mids:
        while i < len(host) and host[i]["ts"] <= mid:
            ev = host[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < ev["ts"]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
            stack.pop()
        inside = [e for e in stack if e["ts"] + e["dur"] >= mid]
        outer = next((e["name"] for e in inside
                      if e["name"].startswith("bench.")
                      and e["name"] != WINDOW), "bench.window")
        inner = inside[-1]["name"] if inside else "none"
        out.append(f"{outer}:{inner}"[:NAME_CHARS])
    return out


def reduce_events(events: List[dict]) -> dict:
    """window_s, busy_s (the union of device events inside the window),
    ``kernels`` (name -> [count, seconds]), and the breakdown's
    ``device_ops`` and ``idle_gaps`` (the top ten by seconds)."""
    windows = [e for e in events if e["name"] == WINDOW
               and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} "
                           f"'{WINDOW}' spans, not one")
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        intervals.append((s, t))
        k = kernels[e["name"]]
        k[0] += 1
        k[1] += (t - s) / 1e6
    busy = _union(intervals)
    busy_s = sum(t - s for s, t in busy) / 1e6
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    thread = (win.get("pid"), win.get("tid"))
    host = [e for e in events if e.get("cat") in HOST_CATS
            and (e.get("pid"), e.get("tid")) == thread and e is not win]
    idle: Dict[str, float] = defaultdict(float)
    for (s, t), label in zip(gaps, _labels(host, [(s + t) / 2
                                                  for s, t in gaps])):
        idle[label] += (t - s) / 1e6
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return dict(
        window_s=(w1 - w0) / 1e6, busy_s=busy_s,
        kernels={k: list(v) for k, v in kernels.items()},
        device_ops=[[k[:NAME_CHARS], v[1]] for k, v in top_ops],
        idle_gaps=[[k, v] for k, v in
                   sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]])


def read_trace(path: Path) -> dict:
    """The reduction of the trace at ``path``, which is removed after."""
    try:
        return reduce_events(load_events(path))
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.remove(path)


def kernel_seconds(kernels: Dict[str, list], patterns) -> Optional[float]:
    """Device seconds of the kernels whose names match any of the compiled
    ``patterns``; None where none ran."""
    hit = [v[1] for k, v in kernels.items()
           if any(p.search(k) for p in patterns)]
    return sum(hit) if hit else None

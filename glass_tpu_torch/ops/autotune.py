"""On-card calibration of the layout planner's cost model (counterpart of
``glass_tpu/ops/autotune.py``).

The planner (``ops/graph.py::_plan_block_sparse``) ranks band, chunked-BCSR
and hybrid layouts with ``t = n_steps * step_cost + streamed_bytes /
stream_bps``. This module times the port's f32 band and BCSR kernels on the
card, fits the three constants by least squares, and writes the JAX
package's three-key calibration file, which ``GLASS_TPU_AUTOTUNE`` points
either package's planner at.

- :func:`fit_cost_constants` — time the same four band and two BCSR
  configurations as the JAX probe, fit band step cost and stream rate, then
  the BCSR per-chunk cost from the residual after the stream term. It
  refuses (:class:`FitRefused`) a non-physical fit and, on the card, a fit
  outside the JAX probe's plausible range (:func:`check_plausible`).
- :func:`ensure_autotune` — the CLI's ``--autotune``: reuse the calibration
  file if it exists (by default a path keyed by the timed kernels' source
  digests), else fit once and write it; then set
  ``GLASS_TPU_AUTOTUNE`` for the process. A refused fit is not written and
  nothing falls back to the defaults.

Timing. The JAX probe times a jitted ``lax.scan`` of launches. Here a CUDA
graph holds ``iters`` launches spread round-robin over ``STREAMS`` (8) CUDA
streams, and CUDA events time its replay (the least of three). The graph
keeps the host's per-launch cost out of the time, and the streams let
launches run side by side, so the time per launch is what a layout costs a
busy card. The kernels run one CTA per 128-row block, and a layout reaches
the card's rate only from about ``ops/graph.py::_CARD_ROW_BLOCKS`` row
blocks on (measured by chip_smoke.py [planner_rates]); the calibration
layouts have 64 to 128, so one at a time their rate would follow their row
count, which the two-term model has no term for. Eight streams keep at
least 512 row blocks in flight. The planner puts the fill back for a
graph with few row blocks. The function that measures is a parameter: a
test feeds the fit synthetic times, and ``device="cpu"`` times the
kernels' plain versions by host clock (for pipeline tests only; those
numbers describe no card).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from glass_tpu_torch.ops._common import BLOCK, resolve_device

# (n_blocks, width, per_block, rps) and (n_blocks, width, per_block): the
# JAX probe's configurations, spanning step counts and slab bytes so that
# the two terms of the model separate in the fit.
BAND_CONFIGS = ((64, 4, 4000, 1), (64, 4, 4000, 8), (128, 8, 8000, 2),
                (128, 2, 2000, 1))
BCSR_CONFIGS = ((64, 4, 4000), (128, 8, 8000))
# The JAX probe's plausible range (glass_tpu/ops/autotune.py): a step of 10
# ns to 1 ms on the TPU's one core, a stream of 1 GB/s to 10 TB/s.
STEP_RANGE_S = (1e-8, 1e-3)
STREAM_RANGE_BPS = (1e9, 1e13)
# streams that share the timed launches (see the module docstring)
STREAMS = 8
# the CUDA sources whose kernels the fit times
TIMED_SOURCES = ("band_spmm", "bcsr_spmm")


class FitRefused(RuntimeError):
    """A fit that the gates reject: nothing is written."""


def check_plausible(band_step_s: float, bcsr_step_s: float, stream_bps: float,
                    sms: int) -> None:
    """Raises :class:`FitRefused` unless a fit on a card of ``sms`` SMs lies
    in the JAX probe's range. The TPU runs one grid step at a time on one
    core, and the range holds that core's time per step. The card runs a
    layout's groups on all its SMs side by side, so the fitted cost per
    group is an SM's time per group over ``sms``: the range holds
    ``step * sms``, each SM's time per step, to the TPU's bounds."""
    for what, step in (("band step", band_step_s), ("BCSR chunk", bcsr_step_s)):
        if not STEP_RANGE_S[0] <= step * sms <= STEP_RANGE_S[1]:
            raise FitRefused(
                f"autotune fit out of plausible range ({what} {step:.3e} s, "
                f"{step * sms:.3e} s per SM over {sms} SMs): refusing to "
                "write")
    if not STREAM_RANGE_BPS[0] <= stream_bps <= STREAM_RANGE_BPS[1]:
        raise FitRefused(f"autotune fit out of plausible range (stream "
                         f"{stream_bps:.3e} B/s): refusing to write")


def _banded_graph(n_blocks: int, width: int, per_block: int, rng):
    """COO of a banded pattern: each 128-row block keeps ``per_block`` edges
    within ``width`` column blocks of the diagonal. Copy of
    ``glass_tpu/ops/autotune.py::_banded_graph``."""
    n = n_blocks * BLOCK
    rows, cols = [], []
    for b in range(n_blocks):
        r = b * BLOCK + rng.integers(0, BLOCK, size=per_block)
        c0 = max(0, min(b - width // 2, n_blocks - width)) * BLOCK
        c = c0 + rng.integers(0, width * BLOCK, size=per_block)
        rows.append(r)
        cols.append(c)
    return np.concatenate(rows), np.concatenate(cols), n


def cuda_graph_seconds(fn: Callable, x: torch.Tensor, iters: int) -> float:
    """Seconds per launch of ``fn(x)`` on the card: a CUDA graph of
    ``iters`` launches spread round-robin over ``STREAMS`` streams, its
    replay timed by CUDA events, the least of three replays."""
    fn(x)  # builds the kernel and warms it outside the capture
    torch.cuda.synchronize()
    side = [torch.cuda.Stream() for _ in range(STREAMS)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = torch.cuda.current_stream()
        for s in side:
            s.wait_stream(cap)
        for i in range(iters):
            with torch.cuda.stream(side[i % STREAMS]):
                fn(x)
        for s in side:
            cap.wait_stream(s)
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best / iters


def host_seconds(fn: Callable, x: torch.Tensor, iters: int) -> float:
    """Seconds per call of ``fn(x)`` on the CPU, by host clock, the least of
    two runs after a warm one (for pipeline tests on the CPU)."""
    fn(x)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        best = min(best, time.perf_counter() - t0)
    return best / iters


def _default_measure(dev: torch.device):
    timer = cuda_graph_seconds if dev.type == "cuda" else host_seconds
    return lambda fn, x, iters, layout: timer(fn, x, iters)


def fit_cost_constants(iters: int = 100, hidden: int = 64, device="cuda",
                       measure: Optional[Callable] = None,
                       log=lambda s: print(s, file=sys.stderr)) -> dict:
    """Times the f32 band and BCSR kernels on ``device`` and fits the
    planner's three constants. Returns the calibration dict (the three keys
    plus the backend, the device's name and SM count, the hidden width and
    the streams).

    ``measure(fn, x, iters, layout)`` returns the seconds per call of
    ``fn(x)``; by default a CUDA graph on the card (:func:`cuda_graph_seconds`)
    or the host clock on the CPU. Raises
    :class:`FitRefused` on a non-physical fit and, on the card, on a fit
    that :func:`check_plausible` refuses."""
    from glass_tpu_torch.ops.band_spmm import band_spmm, build_band
    from glass_tpu_torch.ops.bcsr_spmm import bcsr_spmm, build_bcsr

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    measure = measure or _default_measure(dev)
    rng = np.random.default_rng(0)

    def features(n):
        return torch.from_numpy(
            rng.normal(size=(n, hidden)).astype(np.float32)).to(dev)

    steps_m, bytes_m, times_m = [], [], []
    for n_blocks, width, per_block, rps in BAND_CONFIGS:
        r, c, n = _banded_graph(n_blocks, width, per_block, rng)
        band = build_band(r, c, np.ones(r.size, np.float32), n, rps,
                          device=dev)
        x = features(n)
        dt = measure(lambda v, b=band: band_spmm(b, v), x, iters, band)
        nbytes = band.slabs.numel() * band.slabs.element_size()
        steps_m.append(band.n_groups)
        bytes_m.append(nbytes)
        times_m.append(dt)
        log(f"  band n_blocks={n_blocks} w={width} rps={rps}: "
            f"{band.n_groups} steps, {nbytes / 1e6:.1f} MB, "
            f"{dt * 1e6:.1f} us/iter")

    bcsr_steps, bcsr_bytes, bcsr_times = [], [], []
    for n_blocks, width, per_block in BCSR_CONFIGS:
        r, c, n = _banded_graph(n_blocks, width, per_block, rng)
        bcsr = build_bcsr(r, c, np.ones(r.size, np.float32), n, device=dev)
        x = features(n)
        dt = measure(lambda v, b=bcsr: bcsr_spmm(b, v), x, iters, bcsr)
        n_chunks = int(bcsr.chunk_start.shape[0])
        nbytes = bcsr.blocks.numel() * bcsr.blocks.element_size()
        bcsr_steps.append(n_chunks)
        bcsr_bytes.append(nbytes)
        bcsr_times.append(dt)
        log(f"  bcsr n_blocks={n_blocks} w={width}: {n_chunks} chunks, "
            f"{nbytes / 1e6:.1f} MB, {dt * 1e6:.1f} us/iter")

    a = np.stack([np.asarray(steps_m, float), np.asarray(bytes_m, float)], 1)
    coef, *_ = np.linalg.lstsq(a, np.asarray(times_m), rcond=None)
    if coef[0] <= 0 or coef[1] <= 0:
        raise FitRefused(
            f"autotune fit is non-physical (step_cost={coef[0]:.3e} s, "
            f"byte_cost={coef[1]:.3e} s/B): refusing to write")
    band_step_s = float(coef[0])
    stream_bps = float(1.0 / coef[1])
    resid = np.asarray(bcsr_times) - np.asarray(bcsr_bytes) / stream_bps
    bcsr_step_s = float((resid / np.asarray(bcsr_steps)).mean())
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if on_card else None)
    if on_card:
        check_plausible(band_step_s, bcsr_step_s, stream_bps, sms)
    else:
        # off the card the band's stream rate can overshoot BCSR's byte
        # cost and leave a negative residual; those numbers test the
        # pipeline only
        bcsr_step_s = max(bcsr_step_s, STEP_RANGE_S[0])

    return {
        "band_step_cost_s": band_step_s,
        "bcsr_step_cost_s": bcsr_step_s,
        "stream_bps": stream_bps,
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "sms": sms,
        "hidden": hidden,
        "streams": STREAMS if on_card else None,
    }


def default_autotune_path(device="cuda") -> Path:
    """``$XDG_CACHE_HOME`` (else ``~/.cache``) ``/glass_tpu_torch/`` +
    ``autotune_cuda-<key>.json`` on the card, the key a digest of the
    libraries the fit times (``_build.library_path`` of ``TIMED_SOURCES``,
    whose names carry their sources' digests), so that a fit of other
    kernels is never reused; ``autotune_cpu.json`` on the CPU, which times
    the plain versions."""
    cache = Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache"))
    kind = torch.device(device).type
    if kind != "cuda":
        return cache / "glass_tpu_torch" / f"autotune_{kind}.json"
    from glass_tpu_torch.ops import _build

    names = " ".join(_build.library_path(n).name for n in TIMED_SOURCES)
    key = hashlib.sha256(names.encode()).hexdigest()[:16]
    return cache / "glass_tpu_torch" / f"autotune_cuda-{key}.json"


def ensure_autotune(path: Optional[str] = None, iters: int = 100,
                    hidden: int = 64, refit: bool = False, device="cuda",
                    measure: Optional[Callable] = None) -> str:
    """The CLI's ``--autotune``: reuse the calibration at ``path`` (default
    :func:`default_autotune_path`) or fit once and write it, then export
    ``GLASS_TPU_AUTOTUNE`` so that every later plan of this process uses
    it. Returns the path. A refused fit raises :class:`FitRefused` and
    writes nothing."""
    p = Path(path) if path else default_autotune_path(device)
    if refit or not p.exists():
        fitted = fit_cost_constants(iters=iters, hidden=hidden, device=device,
                                    measure=measure)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(fitted, indent=2) + "\n")
        print(f"autotune: fitted and saved {p}: {fitted}", flush=True)
    else:
        print(f"autotune: using existing calibration {p}", flush=True)
    os.environ["GLASS_TPU_AUTOTUNE"] = str(p)
    return str(p)

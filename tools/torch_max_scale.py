"""The port's scale ladder: GLASS's full training step on one card at
growing multiples of em_user's size (counterpart of tools/max_scale.py).

At each rung the tool generates the clustered graph of ``max_scale.py``
(448·scale communities of 128 nodes, 4.5M·scale undirected edges, 95 %
inside a community, band-ordered by construction), builds it through the
port's entry points (``build_graph(..., "gcn", materialize_bcsr=True)``:
native CSR and fills, the planner's auto layout or the one ``--layout``
forces), and trains em_user's model (hidden 64, 1 conv layer, output 2,
size pool, dropout 0.5, elu, z_ratio 0.75, JK) through ``Trainer`` with ``TrainConfig(lr=1e-3,
batch_size=6, loss="ce")``: one epoch of one step (the eager step and the
capture), a warm epoch, then epochs of ``lo`` and ``hi`` steps timed by
CUDA events, whose difference over ``hi - lo`` steps is a replayed step's
time, and one profiled epoch for the device time. ``--dtype int8`` is int8
slabs with bf16 activations, ``f32`` exact; ``--remat`` trains under
``GLASS_TPU_REMAT=1``, ``--remat_ab`` trains each built graph without
and then with it. GraphNorm runs fused under ``GLASS_TPU_FUSED_NORM=1``,
as everywhere in the port (the record's ``fused_norm``).

One JSON line per rung and setting to stdout: nodes and directed edges;
the seconds to generate and to build, the build split into native CSR,
the planner, the fills and the rest (quantization, checks, the copy to
the card); the process's peak resident bytes in each phase of the
generation and the build (``host_peak_by_phase``: generate, native CSR,
the edge arrays' widening and padding, the symmetry test, the planner,
the fills and quantization, the copy to the card); with ``--digests``,
the sha256 of the graph's edge arrays and of each layout's tensors,
forward and transposed (``digests``; rung 4's are pinned in
chip_smoke.py); the layout chosen (kind, rps, window, groups, affine law) and
its bytes in each direction; on the card, each kernel's relative
distance from its plain version, forward and transposed, on x in the
step's compute dtype; the seconds to the first step; ms a step, device
ms a step (and its largest kernels) and the idle share; peak allocated
bytes; G model edge-traversals a second (``max_scale.py``'s count); the
losses; the card's name and power limit; the process's peak resident
bytes after the build (one rung a process gives each rung's own). A rung
that fails prints its exception on its line, and the walk goes on.
Diagnostics go to stderr.

Usage (on the card; ``--device cpu`` runs the same path on the CPU, eager
and by the host clock, for tests):

  python3 tools/torch_max_scale.py --scales 1,4,10,20,40 --dtype int8
  python3 tools/torch_max_scale.py --scales 4 --dtype f32,int8 --remat_ab
  python3 tools/torch_max_scale.py --scales 20 --dtype f32,int8 --layout band
  python3 tools/torch_max_scale.py --scales 80 --dtype int8   # one a process
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import resource
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from glass_tpu_torch import GLASS, TrainConfig, Trainer, build_graph  # noqa: E402
from glass_tpu_torch import native  # noqa: E402
from glass_tpu_torch.ops import band_spmm as bd  # noqa: E402
from glass_tpu_torch.ops import bcsr_spmm as bs  # noqa: E402
from glass_tpu_torch.nn.modules import _fused_norm_enabled  # noqa: E402
from glass_tpu_torch.ops import graph as tg  # noqa: E402

BATCH, SUB_SIZE, LAYERS, MAX_ID = 6, 32, 1, 16
KERNEL_TOL = 1e-5  # chip_smoke.py's: max |kernel - plain| over max |plain|
DTYPES = {"f32": ("f32", None), "int8": ("int8", "bfloat16")}


def clustered_graph(scale: float, base_comm=448, csz=128, base_e=4_500_000,
                    intra_frac=0.95, seed=0):
    """The bench.py community generator at `scale` x em_user size (chain
    cross-links, band-ordered by construction): the edges of
    ``tools/max_scale.py::clustered_graph``, which draws from seed 0, byte
    for byte. Each draw is written into one preallocated (2, 2e) int64
    array and dropped after its last use, so the generator holds about 24
    bytes a directed edge at its peak."""
    rng = np.random.default_rng(seed)
    n_comm = int(base_comm * scale)
    e = int(base_e * scale)
    n = n_comm * csz
    intra = int(intra_frac * e)
    # row 0: src_i, src_x, dst_i, dst_x; row 1: dst_i, dst_x, src_i, src_x
    ei = np.empty((2, 2 * e), dtype=np.int64)
    src, dst = ei[0, :e], ei[0, e:]
    ci = rng.integers(0, n_comm, size=intra)
    for part in (src[:intra], dst[:intra]):
        np.multiply(ci, csz, out=part)
        part += rng.integers(0, csz, size=intra)
    del ci
    cx = rng.integers(0, n_comm - 1, size=e - intra)
    np.multiply(cx, csz, out=src[intra:])
    src[intra:] += rng.integers(0, csz, size=e - intra)
    np.add(cx, 1, out=dst[intra:])
    del cx
    dst[intra:] *= csz
    dst[intra:] += rng.integers(0, csz, size=e - intra)
    ei[1, :e] = dst
    ei[1, e:] = src
    return ei, n


def steps_for(scale: float) -> int:
    """The longer timed epoch: shorter as steps grow (max_scale.py)."""
    return max(16, min(256, int(256 / scale)))


def rung_inputs(n: int, steps_hi: int):
    """The rung's ids and batches, drawn as max_scale.py draws them:
    (x (n, 1) int64, pos (steps_hi, 6, 32), y (steps_hi, 6) int64)."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, MAX_ID, size=(n, 1)).astype(np.int64)
    pos = rng.integers(0, n, size=(steps_hi, BATCH, SUB_SIZE))
    y = rng.integers(0, 2, size=(steps_hi, BATCH)).astype(np.int64)
    return x, pos, y


def make_model(graph, hidden: int, compute_dtype, device, dropout=0.5,
               seed=0) -> GLASS:
    """em_user's GLASS as max_scale.py builds it, on ``device``."""
    spmm_mode = ("pallas" if graph.band is not None or graph.bcsr is not None
                 or graph.sblock is not None else "segment")
    return GLASS(MAX_ID, hidden, LAYERS, (2,), ("size",), dropout=dropout,
                 activation="elu", z_ratio=0.75, jk=True, spmm_mode=spmm_mode,
                 compute_dtype=compute_dtype, seed=seed, device=device)


def train_config() -> TrainConfig:
    return TrainConfig(lr=1e-3, batch_size=BATCH, loss="ce", use_z=True)


@contextlib.contextmanager
def build_spans(spans: dict):
    """Adds the seconds of the native CSR build, the planner (the block
    pattern it prices from included) and the native fills that build_graph
    calls in the block to ``spans``."""

    def timed(key):
        def wrap(fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
            return call
        return wrap

    with patched([(native, "build_csr", timed("csr_s")),
                  (tg, "block_pattern", timed("plan_s")),
                  (tg, "_plan_block_sparse", timed("plan_s")),
                  (native, "band_fill", timed("fill_s")),
                  (native, "bcsr_fill", timed("fill_s")),
                  (native, "bcsr_fill_rows", timed("fill_s"))]):
        yield spans


PAGE = os.sysconf("SC_PAGE_SIZE")


def rss_bytes() -> int:
    """The process's resident bytes now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE


def max_rss_bytes() -> int:
    """The process's peak resident bytes so far (getrusage)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class HostPeaks:
    """The process's peak resident bytes by phase. A thread reads the
    resident bytes every ``period`` seconds and keeps each phase's largest
    reading; where the process's own peak (getrusage) rose during a phase,
    that peak is the phase's, so a peak between two readings is not lost
    when it set the process's record. ``phase(name)`` switches the phase
    (None: none is measured)."""

    def __init__(self, period: float = 0.002):
        self.period = period
        self.peaks: dict = {}
        self._name = None
        self._max_at_start = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _note(self, value: int) -> None:
        if self._name is not None:
            self.peaks[self._name] = max(self.peaks.get(self._name, 0), value)

    def _sample(self) -> None:
        while not self._stop.wait(self.period):
            with self._lock:
                self._note(rss_bytes())

    def phase(self, name) -> None:
        with self._lock:
            self._note(rss_bytes())
            top = max_rss_bytes()
            if top > self._max_at_start:
                self._note(top)
            self._name, self._max_at_start = name, top

    def close(self) -> dict:
        self.phase(None)
        self._stop.set()
        self._thread.join()
        return self.peaks


# The build's phases, by the functions of the port that mark them: a hook
# switches to its phase when the function is entered and to the phase after
# it when the function returns (the edge arrays' widening and padding follow
# the native CSR; the planner follows the symmetry test; the copy to the
# card follows each layout's fill).
BUILD_PHASES = (
    (native, "build_csr", "csr", "widen"),
    (tg, "coo_is_symmetric", "symmetry", "plan"),
    (tg, "_plan_block_sparse", "plan", "plan"),
    (tg, "_auto_kind", "plan", "plan"),
    (tg, "build_bcsr", "fill", "copy"),
    (tg, "_band_pair", "fill", "copy"),
    (tg, "_hybrid_layouts", "fill", "copy"),
    (bs, "bcsr_from_arrays", "copy", "fill"),
    (bd, "band_from_arrays", "copy", "fill"),
)
PHASES = ("generate", "csr", "widen", "symmetry", "plan", "fill", "copy")


@contextlib.contextmanager
def patched(targets):
    """Each (module, name, wrap) of ``targets``: the module's function
    replaced by ``wrap(function)`` inside the block."""
    real = [getattr(mod, name) for mod, name, _ in targets]
    for (mod, name, wrap), fn in zip(targets, real):
        setattr(mod, name, wrap(fn))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(targets, real):
            setattr(mod, name, fn)


@contextlib.contextmanager
def build_phases(peaks: HostPeaks):
    """``peaks`` switched between the build's phases (BUILD_PHASES) by the
    functions build_graph calls in the block; "copy" from the last layout
    to the block's end."""

    def wrap(enter, leave):
        def hook(fn):
            def call(*args, **kw):
                peaks.phase(enter)
                try:
                    return fn(*args, **kw)
                finally:
                    peaks.phase(leave)
            return call
        return hook

    with patched([(mod, name, wrap(enter, leave))
                  for mod, name, enter, leave in BUILD_PHASES]):
        yield peaks


def tensor_digest(tensors) -> str:
    """sha256 over ``tensors``' (name, dtype, shape, bytes), in order. The
    digests chip_smoke.py and the tests pin were taken in this format."""
    h = hashlib.sha256()
    for name, t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def layout_digests(graph) -> dict:
    """The sha256 of the graph's edge arrays (row, col, weight) and of each
    layout's tensors and sizes, forward and transposed (None where the
    graph has no such layout); the plan beside them."""
    out = dict(plan=graph.plan, csr=tensor_digest(
        [("row", graph.row), ("col", graph.col), ("weight", graph.weight)]))
    for name in ("band", "band_t", "bcsr", "bcsr_t", "dense_q", "dense_q_t"):
        layout = getattr(graph, name)
        if layout is None:
            out[name] = None
            continue
        items = [(f.name, getattr(layout, f.name))
                 for f in dataclasses.fields(layout)]
        out[name] = tensor_digest(
            [(k, v) for k, v in items if isinstance(v, torch.Tensor)]
            + [(f"{k}={v}", torch.zeros(0)) for k, v in items
               if not isinstance(v, torch.Tensor)])
    return out


def tensor_bytes(layout) -> int:
    """The bytes of every tensor a layout holds."""
    if layout is None:
        return 0
    return sum(v.numel() * v.element_size()
               for v in (getattr(layout, f.name)
                         for f in dataclasses.fields(layout))
               if isinstance(v, torch.Tensor))


def layout_record(graph) -> dict:
    """The layout the planner chose and its bytes in each direction."""
    rec = dict(plan=graph.plan)
    if graph.band is not None:
        b = graph.band
        rec["layout"] = dict(kind="band", rps=b.rps, w_blocks=b.w_blocks,
                             groups=b.n_groups, affine=[b.affine_stride,
                                                        b.affine_off],
                             slab_dtype=str(b.slabs.dtype))
    if graph.bcsr is not None:
        c = graph.bcsr
        rec.setdefault("layout", {})
        rec["layout"].update(kind="hybrid" if graph.band is not None
                             else "bcsr", stored_blocks=c.nnz_blocks,
                             block_dtype=str(c.blocks.dtype))
    if graph.sblock is not None:
        rec["layout"] = dict(kind="sblock", blocks=graph.sblock.live_blocks,
                             nnz=graph.sblock.nnz)
    rec.setdefault("layout", dict(kind=graph.plan or "segment"))
    fwd = (tensor_bytes(graph.band) + tensor_bytes(graph.bcsr)
           + tensor_bytes(graph.sblock))
    rev = (tensor_bytes(graph.band_t if graph.band_t is not graph.band
                        else None)
           + tensor_bytes(graph.bcsr_t if graph.bcsr_t is not graph.bcsr
                          else None)
           + tensor_bytes(graph.sblock_t if graph.sblock_t is not graph.sblock
                          else None))
    rec.update(layout_bytes=fwd, layout_t_bytes=rev,
               layout_t_shared=rev == 0 and fwd > 0,
               edge_array_bytes=sum(t.numel() * t.element_size() for t in
                                    (graph.row, graph.col, graph.weight)))
    caps = dict(layout_cap=tg._LAYOUT_BYTES_CAP,
                dense_cap=tg._DENSE_MXU_BYTES_CAP)
    rec["caps"] = dict(caps, layout_under_cap=max(fwd, rev) <= caps[
        "layout_cap"])
    return rec


def card_line(device: torch.device):
    """nvidia-smi's name and power limit on the card; None on the CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def epoch_seconds(trainer, pos, y, device) -> tuple:
    """One epoch over (steps, 6, 32) batches: (seconds by CUDA events on
    the card, by the host clock on the CPU; its step losses)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        res = trainer.train_epoch(pos, y)
        return time.perf_counter() - t0, res.step_losses
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sync(device)
    start.record()
    res = trainer.train_epoch(pos, y)  # ends in the losses' readback
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, res.step_losses


TOP_KERNELS = 8


def device_ms_per_step(trainer, pos, y) -> tuple:
    """The card's kernel time a step over one profiled epoch: (ms, the
    TOP_KERNELS kernels' ms a step by name, largest first)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.train_epoch(pos, y)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    per_step = 1e3 * pos.shape[0]
    top = sorted(events, key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in events) / per_step,
            {e.key[:80]: e.self_device_time_total / per_step
             for e in top[:TOP_KERNELS]})


def train_rung(graph, x, pos, y, hidden: int, compute_dtype, device,
               n_directed: int) -> dict:
    """Trains one built rung (module docstring); the training fields of
    its record."""
    steps_hi = pos.shape[0]
    lo = max(steps_hi // 4, 1)
    if device.type == "cuda":
        # an earlier trainer's captured graph and model (a reference cycle)
        # would count as resident
        gc.collect()
        torch.cuda.empty_cache()
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        resident = torch.cuda.memory_allocated(device)
    model = make_model(graph, hidden, compute_dtype, device)
    trainer = Trainer(model, graph, torch.from_numpy(x).to(device),
                      train_config())
    trainer.init(0)
    t0 = time.perf_counter()
    _, first = epoch_seconds(trainer, pos[:1], y[:1], device)
    first_s = time.perf_counter() - t0  # the eager step and the capture
    _, warm = epoch_seconds(trainer, pos, y, device)
    t_lo = min(epoch_seconds(trainer, pos[:lo], y[:lo], device)[0]
               for _ in range(2))
    his = [epoch_seconds(trainer, pos, y, device) for _ in range(2)]
    t_hi = min(t for t, _ in his)
    dt = max(t_hi - t_lo, 1e-9) / (steps_hi - lo)
    rec = dict(graphed=trainer._steps.graph is not None, steps_lo=lo,
               steps_hi=steps_hi, first_step_s=first_s, ms_per_step=dt * 1e3,
               steps_per_s=1.0 / dt,
               edges_per_s=2 * LAYERS * n_directed / dt / 1e9,
               losses=[float(v) for v in np.concatenate([first, warm])],
               last_epoch_losses=[float(v) for v in his[-1][1]])
    if device.type == "cuda":
        dev_ms, by_kernel = device_ms_per_step(trainer, pos, y)
        rec.update(device_ms_per_step=dev_ms,
                   device_ms_by_kernel=by_kernel,
                   idle_share=1 - dev_ms / rec["ms_per_step"],
                   resident_bytes=resident,
                   peak_allocated_bytes=torch.cuda.max_memory_allocated(
                       device))
    else:
        rec.update(device_ms_per_step=None, device_ms_by_kernel=None,
                   idle_share=None,
                   resident_bytes=None, peak_allocated_bytes=None)
    return rec


@contextlib.contextmanager
def remat_env(on: bool):
    old = os.environ.get("GLASS_TPU_REMAT")
    os.environ["GLASS_TPU_REMAT"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("GLASS_TPU_REMAT")
        else:
            os.environ["GLASS_TPU_REMAT"] = old


def check_kernels(graph, hidden: int, device, compute_dtype=None) -> dict:
    """On the card, each SpMM kernel of the rung's layout and of its
    transposed layout where it has its own, against its plain version on
    one x in the step's compute dtype (f32 by default): at this size a
    32-bit offset that wraps shows as a wrong row. Raises past KERNEL_TOL;
    the worst relative error and each layout's."""
    if device.type != "cuda":
        return dict(kernel_rel_err=None, kernel_rel_errs=None,
                    kernel_x_dtype=None)
    dtype = getattr(torch, compute_dtype or "float32")
    x = torch.randn(graph.n_node, hidden, device=device,
                    generator=torch.Generator(device=device).manual_seed(2)
                    ).to(dtype)
    pairs = [("band", bd.band_spmm, bd.band_spmm_reference),
             ("band_t", bd.band_spmm, bd.band_spmm_reference),
             ("bcsr", bs.bcsr_spmm, bs.bcsr_spmm_reference),
             ("bcsr_t", bs.bcsr_spmm, bs.bcsr_spmm_reference)]
    errs, seen = {}, set()
    for name, kernel, plain in pairs:
        layout = getattr(graph, name)
        if layout is None or id(layout) in seen:
            continue
        seen.add(id(layout))
        out, ref = kernel(layout, x), plain(layout, x)
        err = float((out - ref).abs().max()) / float(ref.abs().max())
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"{name}: {kernel.__name__} differs from its "
                               f"plain version by {err} of max |plain|")
        errs[name] = err
        del out, ref
    return dict(kernel_rel_err=max(errs.values()), kernel_rel_errs=errs,
                kernel_x_dtype=str(dtype).removeprefix("torch."))


def build_rung(ei, n: int, dtype: str, hidden: int, device,
               layout: str = "auto", peaks: HostPeaks = None,
               digests: bool = False) -> tuple:
    """build_graph of one rung's edges at ``dtype`` on ``device`` in the
    ``layout`` build_graph's ``sparse_layout`` names: (the graph, the
    record's build and layout fields). ``peaks``: the HostPeaks the
    build's phases are measured in (a new one by default). ``ei`` may be a
    one-element list, which the call empties, so that the build holds the
    only reference to the edges and drops them after the CSR."""
    dense_dtype, _ = DTYPES[dtype]
    spans = {"csr_s": 0.0, "plan_s": 0.0, "fill_s": 0.0}
    own = peaks is None
    peaks = HostPeaks() if own else peaks
    t0 = time.perf_counter()
    try:
        with build_spans(spans), build_phases(peaks):
            peaks.phase("csr")
            graph = build_graph(ei.pop() if isinstance(ei, list) else ei,
                                None, n, "gcn", materialize_dense=False,
                                materialize_bcsr=True, sparse_layout=layout,
                                dense_dtype=dense_dtype, device=device)
            peaks.phase("copy")
            sync(device)
        peaks.phase(None)
    finally:
        if own:
            peaks.close()
    build_s = time.perf_counter() - t0
    rec = dict(sparse_layout=layout, build_s=build_s,
               **{f"build_{k}": v for k, v in spans.items()},
               build_other_s=build_s - sum(spans.values()),
               host_peak_rss_bytes=max_rss_bytes(),
               host_peak_by_phase={k: peaks.peaks[k] for k in PHASES
                                   if k in peaks.peaks},
               native=native.is_available(),
               digests=layout_digests(graph) if digests else None,
               **layout_record(graph))
    # max_scale.py's model: the layout, 6 (n, hidden) f32 rounds and the
    # optimizer's state
    rec["jax_budget_model_bytes"] = (rec["layout_bytes"] + 6 * n * hidden * 4
                                     + 3 * 4 * hidden * hidden)
    return graph, rec


def probe_scale(scale: float, dtype: str, hidden: int, remats, device,
                steps_hi=None, layout: str = "auto",
                digests: bool = False) -> list:
    """Generates, builds and trains one rung; one record per remat
    setting."""
    _, compute_dtype = DTYPES[dtype]
    base = dict(scale=scale, dtype=dtype, compute_dtype=compute_dtype or
                "float32", hidden=hidden, fused_norm=_fused_norm_enabled(),
                device=str(device), card=card_line(device))
    peaks = HostPeaks()
    peaks.phase("generate")
    t0 = time.perf_counter()
    ei, n = clustered_graph(scale)
    n_directed = int(ei.shape[1])
    base.update(n_node=n, directed_edges=n_directed,
                generate_s=time.perf_counter() - t0)
    print(f"[scale {scale} {dtype}] {n} nodes, {n_directed / 1e6:.1f}M "
          f"directed edges", file=sys.stderr, flush=True)
    edges = [ei]
    del ei  # the build holds the only reference
    try:
        graph, built = build_rung(edges, n, dtype, hidden, device, layout,
                                  peaks, digests)
    finally:
        peaks.close()
    base.update(built)
    print(f"[scale {scale} {dtype}] layout {base['layout']}, built in "
          f"{base['build_s']:.1f} s, host peaks "
          f"{ {k: round(v / 1e9, 2) for k, v in base['host_peak_by_phase'].items()} } GB",
          file=sys.stderr, flush=True)
    base.update(check_kernels(graph, hidden, device, compute_dtype))
    x, pos, y = rung_inputs(n, steps_hi or steps_for(scale))
    out = []
    for on in remats:
        with remat_env(on):
            rec = dict(base, remat=on)
            rec.update(train_rung(graph, x, pos, y, hidden, compute_dtype,
                                  device, n_directed))
        print(f"[scale {scale} {dtype} remat {on}] {rec['ms_per_step']:.3f} "
              f"ms a step", file=sys.stderr, flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", type=str, default="1,4,10,20,40")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--remat", action="store_true",
                    help="train under GLASS_TPU_REMAT=1")
    ap.add_argument("--remat_ab", action="store_true",
                    help="train each built graph without, then with remat")
    ap.add_argument("--dtype", type=str, default="int8",
                    help="comma list of f32 (exact) and int8 (int8 slabs, "
                         "bf16 activations)")
    ap.add_argument("--layout", type=str, default="auto",
                    choices=tg.SPARSE_LAYOUTS,
                    help="build_graph's sparse_layout (default: the "
                         "planner's choice)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--steps", type=int, default=None,
                    help="the longer timed epoch (default: max_scale.py's)")
    ap.add_argument("--digests", action="store_true",
                    help="the sha256 of the edge arrays and layout tensors "
                         "in the record (copies them to the host)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_max_scale: no CUDA card; pass --device cpu",
              file=sys.stderr)
        return 1
    remats = (False, True) if args.remat_ab else (args.remat,)
    for s in [float(t) for t in args.scales.split(",")]:
        for dtype in args.dtype.split(","):
            try:
                recs = probe_scale(s, dtype, args.hidden, remats, device,
                                   args.steps, args.layout, args.digests)
            except Exception as e:  # record the failing rung, keep walking
                recs = [dict(scale=s, dtype=dtype, device=str(device),
                             card=card_line(device),
                             failed=f"{type(e).__name__}: {e}"[:2000])]
                print(f"[scale {s} {dtype}] FAILED: {recs[0]['failed']}",
                      file=sys.stderr, flush=True)
            for rec in recs:
                print(json.dumps(rec), flush=True)
            gc.collect()  # the rung's trainers and graph (reference cycles)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

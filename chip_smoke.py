#!/usr/bin/env python3
"""Drives the PyTorch/H100 port of GLASS, serving, training and the
experiment CLI, on one CUDA card and checks it.

Run from the root of the repository, on a machine with one card:

    python3 chip_smoke.py

Phases, one printed line each:
  1. device  — no CUDA means a non-zero exit; prints the card's name and
               power limit as nvidia-smi gives them.
  2. build   — compiles every CUDA source of glass_tpu_torch/csrc with nvcc
               (one process per source, all started together).
     probe_small — the HBM read probes (csrc/hbm_probe.cu, both TPU bodies
               of tools/hbm_probe.py) against their plain versions,
               bit-equal, repeats bit-identical, at S 1-8, three chunk sizes
               and iters 1 and 3;
     probe_main — tools/torch_hbm_probe.py's probes at 512 MiB: GB/s and
               the share of 3.35 TB/s of the copy probe, read at S 1-8 and
               read2 at S 2 and 4.
  3. kernel vs plain, small layout — the f32 BCSR kernel (3xTF32 over the
               live blocks) against its plain PyTorch version on a layout
               with empty row blocks, CHUNK padding and a row of more than 8
               nonzero blocks and on one whose values span 2^-20 to 2^4,
               with f32 and bf16 x, at H = 17 and 128; and a small GLASS on
               the card against the same model on the CPU.
  4. main path at the em_user configuration (glass_tpu/configs/em_user.yml)
     on a 57,344-node, 9M-edge stand-in graph (the recipe of
     bench.py::clustered_graph): the graph build; the kernel against its
     plain version, timed beside torch.sparse.mm, also at component's H =
     17; then requests of 1, 6 and 64 subgraphs served through Predictor,
     each sent twice, with the kernel's launch count read around them, the
     repeat checked bit-identical and the logits checked against the
     independent "segment" SpMM mode; train_bcsr — Trainer epochs of the
     em_user configuration on the same BCSR layout (the BCSR backward at
     full scale), 2 BCSR launches per conv layer and step, losses falling.
  5. the band kernel and the backward passes on small layouts:
     kernel_band_small — the band kernel (f32 slabs: 3xTF32 on the tensor
               cores) against its plain version at H = 17, 64 and 128 on an
               affine layout (negative offset, bottom overhang), a
               per-group layout (the affine gate rejects a piecewise
               profile), a layout with empty groups and n % 128 != 0 and
               one whose values span 2^-20 to 2^4, each call repeated
               bit-identically;
     grad_small — on an asymmetric ("mean") graph, dx through each kernel's
               autograd Function against dx through its plain version's
               autograd, band and BCSR;
     train_small — a small GLASS trained 3 steps on the card and on the CPU
               with dropout 0, band and BCSR, losses and parameters compared.
  6. the training path at the em_user configuration on the same stand-in
     graph, banded-slab layout at the planner's rps, window and affine law
     (EM_USER_BAND_LAW): graph_band (the build), kernel_band_main
     (the kernel against its plain version at H = 17, 64 and 128, timed at
     64 beside torch.sparse.mm and its bounds: FMA, 3xTF32 and the lesser),
     train (Trainer epochs with em_user's dropout, batch and
     lr on synthetic subgraphs labelled by size, the band kernel's launches
     read around them: 2 per conv layer and step), request_band (requests
     served on the band graph, checked as in 4).
  7. mixed precision, small: kernel_q_small — every bf16 and int8
     instantiation of both kernels (the TMA + wgmma pipeline) against its
     plain version (band: bf16 and int8 slabs x f32 and bf16 x on the
     layouts of 5 at H = 17, 64, 128; BCSR: bf16 and int8 blocks on the
     layout of 3; the int8 dense kernel, csrc/dense_q_spmm.cu, at n = 700
     and 1,100 with an all-zero row, H = 17, 64 and 200, f32 and bf16 x,
     one CTA per output tile over the whole k window), each call repeated
     bit-identically; grad_q_small — dx through each autograd
     Function against the plain autograd on an asymmetric graph, in x's
     dtype; train_q_small — 3 steps card vs CPU with bf16 compute on int8
     and bf16 adjacencies.
  8. the em_user path in mixed precision (dense_dtype "int8", compute_dtype
     "bfloat16") on the stand-in: graph_band_q (the planner's rps 1,
     window 3, clo = g - 1), kernel_band_q_main, train_q
     (2 int8-band launches per step and no other SpMM kernel, losses falling,
     micro-F1 beside the f32 run's), request_band_q (requests against the
     f32 "segment" model with the same weights, within the JAX package's own
     bf16 bound); then the bf16 band and the int8 BCSR layouts at the
     em_user shape: kernel_band_bf16_main, kernel_bcsr_q_main and requests
     served on each.
  9. the dense route at hpo scale (glass_tpu/configs/hpo_metab.yml on the
     14,587-node, 2.6M-edge recipe of bench.py::hpo_graph, dense_dtype
     "int8"): graph_dense_q (dense_q built, dense_q_t is dense_q),
     kernel_dense_q_main (the TMA + wgmma kernel of csrc/dense_q_spmm.cu
     beside its bound and torch.matmul of q's bf16 copy, then the scale),
     train_dense_q (6 synthetic classes, ce loss, 2 launches per step and
     no band kernel).
 9b. the layout planner (phases 1-9 force their layouts):
     planner_rates — the rates the calibration does not fit: torch.matmul
               at the hpo shape (f32, bf16), the "segment" SpMM at em_user,
               and the card's fill (the band kernel alone against a busy
               card at 32-96 and 448 row blocks);
     autotune — ensure_autotune on the card into a temporary file (the
               CLI's --autotune), the fitted constants printed, the em_user
               stand-in planned under them;
     planner_main — the planner's choice (kind, rps, window, modeled costs)
               on the em_user and hpo stand-ins, f32 and int8, built as the
               protocol's "pallas" route builds them, each kernel of the
               chosen layout against its plain version and the SpMM timed;
               on hpo one training epoch, its launches those of the chosen
               layout, and the layout ranked next built and timed;
     hybrid_main — the em_user stand-in plus 8,000 far edges between the
               first and last communities with sparse_layout="hybrid": the
               band carries the bulk, the per-group band kernel and the BCSR
               residue held against their plain versions and timed, 2 band
               and 2 BCSR launches per training step, requests within rtol
               1e-4 of the "segment" mode.
 10. the fused GraphNorm (glass_tpu_torch/csrc/graph_norm.cu; phases 1-9
     run with GLASS_TPU_FUSED_NORM=0, the JAX package's default):
     kernel_norm_small — each of the five passes against its plain version
               at N in (1, 1000, 3001), F in (17, 64, 200), f32 and bf16 x
               with a zero-variance column, repeats bit-identical; the
               autograd Function against the plain Function and the unfused
               graph_norm's autograd;
     kernel_norm_main — each pass at the em_user shape (57,344 x 64), f32
               and bf16, its device time beside its bound, its plain
               version and the library call where there is one; one norm's
               forward + backward profiled fused and unfused;
     train_norm_small — 3 steps card vs CPU with the fused norm.
 11. cli_em_user — the experiment CLI (glass_tpu_torch.cli.glass_test.main,
     in this process) at em_user on a SubGNN-format stand-in written to a
     temporary directory (the graph of 4, size-labelled subgraphs split
     240/60/60): 2 repeats with the fused norm, every training epoch's
     launches checked against the model (2 band launches per conv layer and
     step, K1-K5 once per GraphNorm and step), the best-val checkpoint
     served through Predictor.from_checkpoint; the same command unfused, 1
     repeat, its first epoch losses held to the fused run's and both runs'
     times per step printed (the A/B); cli_em_user_q — 1 repeat with int8
     slabs and bf16 activations, every norm pass in bf16; cli_em_user_auto
     — the CLI's default route, no --spmm and no --sparse_layout (RCM, the
     "pallas" route, the planner's layout), its launches per step checked
     against the planned layout and the layout's kernels against their
     plain versions.
Then the card line again, one {"kernels": [...]} JSON line and, last,
{"ok": true, "device": {...}}. Any failure exits non-zero without that line.
In the kernels line an SpMM kernel's "ms", "plain_ms" and "library_ms" are
CUDA-event times of eager calls (time_ms), which include the host's work
where the card outruns it; "device_ms", "plain_device_ms" and
"library_device_ms" are the same three calls' device time with the L2 cache
flushed before each call (cold_ms).
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from glass_tpu_torch import (GLASS, Predictor, TrainConfig, Trainer,
                             build_graph, make_eval_batches,
                             make_train_batches)
from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import band_spmm as bd
from glass_tpu_torch.ops import bcsr_spmm as bs
from glass_tpu_torch.ops import dense_q as dq
from glass_tpu_torch.ops import fused_norm as fn
from glass_tpu_torch.ops import hbm_probe as hp
from glass_tpu_torch.ops._common import BLOCK
from glass_tpu_torch.ops.graph import degrees
from glass_tpu_torch.ops.norm import graph_norm
from glass_tpu_torch.ops.spmm import spmm
from glass_tpu_torch.train.metrics import pad_eval_labels

# glass_tpu/configs/em_user.yml; activation "elu" as the experiment protocol
# builds GLASS (glass_tpu/train/protocol.py::make_glass_model).
EM_USER = dict(hidden_dim=64, conv_layer=1, pool="size", z_ratio=0.75, jk=True,
               aggr="gcn", batch_size=6, activation="elu", dropout=0.5,
               lr=1e-3, resi=0.7)
N_COMM, COMM_SIZE, UNDIRECTED_EDGES = 448, 128, 4_500_000
# (rps, w_blocks, affine stride, affine offset) of the band the planner
# gives the stand-in under the H100's constants, at every dense_dtype (the
# JAX builder's TPU constants give (2, 4, 2, -1))
EM_USER_BAND_LAW = (1, 3, 1, -1)
REQUEST_BATCHES = (1, EM_USER["batch_size"], 64)
NARROW_H = 17  # glass_tpu/configs/component.yml's hidden width
# the training phase: synthetic subgraphs (train + eval) and epochs
TRAIN_SUBGRAPHS, EVAL_SUBGRAPHS, TRAIN_EPOCHS = 240, 60, 4
# the CPU parity tolerances of tests/test_torch_train.py
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL_LRS = 1e-4, 3

# glass_tpu/configs/hpo_metab.yml
HPO_METAB = dict(hidden_dim=64, conv_layer=1, pool="sum", z_ratio=0.55,
                 jk=True, aggr="gcn", batch_size=59, activation="elu",
                 dropout=0.5, lr=1e-3, resi=0.2)
HPO_NODES, HPO_DIRECTED_EDGES, HPO_CLASSES = 14587, 2_600_000, 6
HPO_SUBGRAPHS, HPO_EPOCHS = 6 * 59, 3
# card vs CPU with bf16 compute: bf16 rounds at other places on the two
# devices (cuBLAS and the CPU's GEMMs), as between JAX and PyTorch, where
# tests/test_torch_train.py measured 2.0e-3 at most
TRAIN_Q_LOSS_RTOL = 1e-2
# requests of the int8 + bf16 model against the same weights in f32 on the
# exact f32 "segment" SpMM: the JAX package's own bound for its bf16 mode
# (tests/test_mixed_precision.py:54)
QUANT_RTOL, QUANT_ATOL = 0.1, 0.05

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, dense bf16 and
# TF32 on the tensor cores, HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_PER_S = 3.35e12

KERNEL_TOL = 1e-5  # max |kernel - plain| <= KERNEL_TOL * max |plain|


def emit(phase: str, **fields) -> None:
    print(f"[{phase}] {json.dumps(fields)}", flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def clustered_graph(n_comm=N_COMM, csz=COMM_SIZE, e=UNDIRECTED_EDGES,
                    intra_frac=0.95, seed=0):
    """em_user-scale synthetic with community structure (cross edges between
    chain-adjacent communities), standing in for an RCM-ordered real graph;
    the recipe of bench.py::clustered_graph. Returns (edge_index, n)."""
    rng = np.random.default_rng(seed)
    n = n_comm * csz
    intra = int(intra_frac * e)
    ci = rng.integers(0, n_comm, size=intra)
    src_i = ci * csz + rng.integers(0, csz, size=intra)
    dst_i = ci * csz + rng.integers(0, csz, size=intra)
    cx = rng.integers(0, n_comm - 1, size=e - intra)
    src_x = cx * csz + rng.integers(0, csz, size=e - intra)
    dst_x = (cx + 1) * csz + rng.integers(0, csz, size=e - intra)
    src = np.concatenate([src_i, src_x])
    dst = np.concatenate([dst_i, dst_x])
    return np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])]), n


def small_layout_edges(seed=1):
    """A 1,445-node directed graph (n % 128 != 0) whose row block 0 touches
    10 column blocks (two chunks), row blocks 3 and 5 have no edges, and
    some edges repeat."""
    rng = np.random.default_rng(seed)
    n = 11 * BLOCK + 37
    rows, cols = [], []
    for cb in range(10):
        rows.append(rng.integers(0, BLOCK, 40))
        cols.append(cb * BLOCK + rng.integers(0, BLOCK, 40))
    r = rng.integers(BLOCK, n, 3000)
    r = r[(r // BLOCK != 3) & (r // BLOCK != 5)]
    rows.append(r)
    cols.append(rng.integers(0, n, r.size))
    ei = np.stack([np.concatenate(rows), np.concatenate(cols)])
    ei = np.concatenate([ei, ei[:, :200]], axis=1)  # duplicates
    return ei, rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32), n


def time_ms(fn, groups=15, per_group=10, warmup=3) -> float:
    """Median over groups of the mean time of one call, from CUDA events
    around ``per_group`` back-to-back calls (so the card never waits on the
    host between them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / per_group for s, e in spans)


# an SpMM record's times and bound, as its phase line prints them
TIME_KEYS = ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
             "library_device_ms", "bound_ms", "bound_by")


def timed(fn, plain, library) -> dict:
    """A kernels-line record's times of a kernel, its plain version and the
    library call, each two ways, so that every pair of numbers compares
    like with like: "ms", "plain_ms", "library_ms" by time_ms (eager
    calls); "device_ms", "plain_device_ms", "library_device_ms" by
    cold_ms (the call's kernels alone, the L2 cache flushed before it)."""
    out = {}
    for key, f in (("", fn), ("plain_", plain), ("library_", library)):
        out[f"{key}ms"] = time_ms(f)
        out[f"{key}device_ms"] = cold_ms(f)
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_vs_plain(what: str, fn, plain, x) -> tuple:
    """(max |kernel - plain|, max |plain|) of fn(x) against plain(x); fails
    past the tolerance, on a non-finite value or if a repeated call differs
    in any bit."""
    out, again, ref = fn(x), fn(x), plain(x)
    sync(x.device)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    check(out.dtype == torch.float32 and out.shape == ref.shape,
          f"{what}: output {out.dtype} {tuple(out.shape)}")
    check(torch.isfinite(out).all().item(), f"{what}: non-finite output")
    check(torch.equal(out, again), f"{what}: repeated call differs")
    check(err <= KERNEL_TOL * scale,
          f"{what}: max|diff| {err} > {KERNEL_TOL} * {scale}")
    return err, scale


def nonzero_blocks(bcsr) -> int:
    """Stored 128x128 blocks that hold at least one nonzero (this data's
    work; the rest is CHUNK padding)."""
    b = bcsr.blocks.view(-1, BLOCK, bs.CHUNK, BLOCK)
    return int((b != 0).any(dim=3).any(dim=1).sum())


def reckonings(nz: int, blocks, table_bytes: int, x, n_out: int) -> dict:
    """Each way this card can compute out = A @ x at the layout's
    precision -> (ms, "bytes" | "operations"), the larger of its two terms
    on the card's published peaks. Bytes: the ``nz`` nonzero 128x128 blocks
    of the layout's ``blocks`` tensor (at its itemsize), its index and
    scale tables (``table_bytes``) and x read once, the f32 output written
    once. Operations: 2 * 128 * 128 * H products per nonzero block. bf16
    and int8 blocks multiply bf16 x: one way, bf16 products on the tensor
    cores ("bf16"). f32 blocks have two f32-accurate ways: f32 FMA outside
    the tensor cores ("fma") and three TF32 products on them ("3xtf32")."""
    h = x.shape[1]
    nbytes = (nz * BLOCK * BLOCK * blocks.element_size() + table_bytes
              + x.numel() * x.element_size() + n_out * h * 4)
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    flop = 2.0 * nz * BLOCK * BLOCK * h
    ops = ({"fma": flop / PEAK_F32_FLOPS, "3xtf32": 3 * flop / PEAK_TF32_FLOPS}
           if blocks.dtype == torch.float32 else
           {"bf16": flop / PEAK_BF16_FLOPS})
    return {k: ((t * 1e3, "operations") if t * 1e3 >= t_bytes
                else (t_bytes, "bytes")) for k, t in ops.items()}


def least_ms(nz: int, blocks, table_bytes: int, x, n_out: int) -> tuple:
    """(least time in ms, "bytes" | "operations") for out = A @ x: the
    lesser of the layout's reckonings (for f32 blocks the FMA one and the
    3xTF32 one, each the larger of its bytes and operations terms)."""
    return min(reckonings(nz, blocks, table_bytes, x, n_out).values())


def scale_bytes(layout) -> int:
    return 0 if layout.row_scale is None else layout.row_scale.numel() * 4


def bound_ms(bcsr, x) -> tuple:
    """least_ms of a BCSR layout: its nonzero blocks, their column ids, the
    row pointers and the row scale."""
    nz = nonzero_blocks(bcsr)
    return least_ms(nz, bcsr.blocks,
                    nz * 4 + (bcsr.n_rb + 1) * 4 + scale_bytes(bcsr), x,
                    bcsr.n_node)


def csr_adjacency(graph) -> torch.Tensor:
    """The normalized adjacency as a torch CSR tensor: the library
    yardstick's input (torch.sparse.mm), timed only, never used by the
    port."""
    n, n_e = graph.n_node, graph.n_edge
    with warnings.catch_warnings():  # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([graph.row[:n_e], graph.col[:n_e]]),
            graph.weight[:n_e], (n, n), check_invariants=True,
        ).coalesce().to_sparse_csr()


def make_request(rng, batch: int, n_comm: int, csz: int):
    """``batch`` subgraphs of 8-250 nodes, each drawn from 1-3 neighbouring
    communities."""
    subs = []
    for _ in range(batch):
        k = int(rng.integers(1, 4))
        c0 = int(rng.integers(0, n_comm - k + 1))
        size = min(int(rng.integers(8, 251)), k * csz)
        nodes = rng.choice(np.arange(c0 * csz, (c0 + k) * csz), size, replace=False)
        subs.append(nodes.tolist())
    return subs


def degree_features(ei, n) -> np.ndarray:
    """(n, 1) degree-bucket feature ids (glass_tpu/data/basegraph.py
    set_degree_feature): the rank of each node's degree among the unique
    degrees."""
    deg = degrees(ei, None, n).astype(np.int64)
    _, inv = np.unique(deg, return_inverse=True)
    return inv.reshape(n, 1)


def em_user_model(max_deg: int, spmm_mode: str, device,
                  dropout: float = 0.0, compute_dtype=None) -> GLASS:
    return GLASS(max_deg, EM_USER["hidden_dim"], EM_USER["conv_layer"], (1,),
                 (EM_USER["pool"],), activation=EM_USER["activation"],
                 z_ratio=EM_USER["z_ratio"], jk=EM_USER["jk"],
                 dropout=dropout, spmm_mode=spmm_mode,
                 compute_dtype=compute_dtype, seed=0, device=device)


def wide_range_bcsr(device):
    """An f32 BCSR layout whose values span 2^-20 to 2^4 ("sum" keeps
    them)."""
    rng = np.random.default_rng(19)
    ei, n = clustered_graph(10, BLOCK, 5000, seed=9)
    w = np.exp2(rng.uniform(-20, 4, ei.shape[1])).astype(np.float32)
    bcsr = build_graph(ei, w, n, "sum", materialize_dense=False,
                       materialize_bcsr=True, sparse_layout="bcsr",
                       device=device).bcsr
    nz = bcsr.blocks[bcsr.blocks != 0].abs()
    check(float(nz.min()) < 2.0 ** -18 and float(nz.max()) > 2.0 ** 2,
          "the wide-range BCSR layout does not span 2^-20 to 2^4")
    return bcsr


def phase_small(device) -> None:
    """The f32 kernel on small layouts (f32 and bf16 x), and a small model
    card-vs-CPU."""
    gen = torch.Generator().manual_seed(0)
    ei, w, n = small_layout_edges()
    graph = build_graph(ei, w, n, "sum", materialize_dense=False,
                        materialize_bcsr=True, sparse_layout="bcsr",
                        device=device)
    bcsr = graph.bcsr
    ptr = bcsr.block_row_ptr.cpu().numpy()
    counts = np.diff(ptr)
    check(counts[0] > 8 and counts[3] == 0 and counts[5] == 0,
          f"small layout lacks its cases: blocks per row {counts.tolist()}")
    check(bcsr.live_blocks < bcsr.nnz_blocks,
          "the small layout has no CHUNK padding to skip")
    layouts = {"wide_row_empty_rows": bcsr,
               "wide_range": wide_range_bcsr(device)}
    for name, layout in layouts.items():
        for xdt in X_DTYPES:  # bf16 x: widened exactly
            for h in (17, 128):
                x = torch.randn(layout.n_node, h, generator=gen).to(device,
                                                                    xdt)
                err, scale = check_vs_plain(
                    f"bcsr {name} x {xdt} H={h}",
                    lambda v: bs.bcsr_spmm(layout, v),
                    lambda v: bs.bcsr_spmm_reference(layout, v), x)
                emit("kernel_small", layout=name, x=str(xdt), H=h,
                     n_node=layout.n_node, stored_blocks=layout.nnz_blocks,
                     live_blocks=layout.live_blocks, max_abs_err=err,
                     max_abs_ref=scale)

    sym = np.concatenate([ei, ei[::-1]], axis=1)
    feats = np.random.default_rng(2).integers(0, 6, (n, 1))
    subs = make_request(np.random.default_rng(3), 8, 11, BLOCK)
    logits = {}
    for dev in (device, torch.device("cpu")):
        g = build_graph(sym, None, n, "gcn", materialize_dense=False,
                        materialize_bcsr=True, sparse_layout="bcsr", device=dev)
        model = em_user_model(5, "pallas", dev)
        pred = Predictor(model, g, torch.from_numpy(feats).to(dev), device=dev)
        logits[dev.type] = pred(subs)
    ref = logits["cpu"]
    err = float(np.abs(logits[device.type] - ref).max())
    check(err <= 1e-4 * np.abs(ref).max() + 1e-6,
          f"small GLASS card vs CPU: max|diff| {err}")
    emit("model_small", n_node=n, subgraphs=len(subs), max_abs_err=err,
         max_abs_ref=float(np.abs(ref).max()))


def phase_main(device, n_comm=N_COMM, csz=COMM_SIZE, edges=UNDIRECTED_EDGES):
    """The em_user main path. Returns the kernel's record for the kernels
    line."""
    gen = torch.Generator().manual_seed(1)
    ei, n = clustered_graph(n_comm, csz, edges)
    t0 = time.perf_counter()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="bcsr", device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    bcsr = graph.bcsr
    emit("graph", n_node=n, directed_edges=graph.n_edge,
         nonzero_blocks=nonzero_blocks(bcsr), stored_blocks=bcsr.nnz_blocks,
         row_blocks=bcsr.n_rb, symmetric=graph.bcsr_t is bcsr,
         build_s=build_s)

    h = EM_USER["hidden_dim"]
    x = torch.randn(n, h, generator=gen).to(device)
    err, scale = check_vs_plain("em_user bcsr",
                                lambda v: bs.bcsr_spmm(bcsr, v),
                                lambda v: bs.bcsr_spmm_reference(bcsr, v), x)
    adj = csr_adjacency(graph)
    lib = torch.sparse.mm(adj, x)
    lib_err = float((lib - bs.bcsr_spmm_reference(bcsr, x)).abs().max())
    record = dict(
        name="bcsr_spmm", route="cuda",
        source="glass_tpu_torch/csrc/bcsr_spmm.cu",
        replaces="glass_tpu/ops/pallas_spmm.py:411",
        tpu=["glass_tpu/ops/pallas_spmm.py:321 _bcsr_chunk_kernel",
             "glass_tpu/ops/pallas_spmm.py:411 _bcsr_chunk_kernel_large"],
        max_abs_err=err,
        **timed(lambda: bs.bcsr_spmm(bcsr, x),
                lambda: bs.bcsr_spmm_reference(bcsr, x),
                lambda: torch.sparse.mm(adj, x)),
    )
    record["bound_ms"], record["bound_by"] = bound_ms(bcsr, x)
    emit("kernel_main", H=h, max_abs_err=err, max_abs_ref=scale,
         library_max_abs_diff=lib_err, live_blocks=bcsr.live_blocks,
         **{k: record[k] for k in TIME_KEYS})
    # component's width (glass_tpu/configs/component.yml) at this shape
    x17 = torch.randn(n, NARROW_H, generator=gen).to(device)
    err17, scale17 = check_vs_plain(
        f"em_user bcsr H={NARROW_H}", lambda v: bs.bcsr_spmm(bcsr, v),
        lambda v: bs.bcsr_spmm_reference(bcsr, v), x17)
    narrow = dict(H=NARROW_H, max_abs_err=err17, max_abs_ref=scale17,
                  **timed(lambda: bs.bcsr_spmm(bcsr, x17),
                          lambda: bs.bcsr_spmm_reference(bcsr, x17),
                          lambda: torch.sparse.mm(adj, x17)))
    narrow["bound_ms"], narrow["bound_by"] = bound_ms(bcsr, x17)
    emit("kernel_main_narrow", **narrow)
    record["narrow_h"] = narrow
    del adj, lib, x17

    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    max_deg = int(feats_np.max())
    model = em_user_model(max_deg, "pallas", device)
    pred = Predictor(model, graph, feats, device=device)
    rng = np.random.default_rng(4)
    requests = [make_request(rng, b, n_comm, csz) for b in REQUEST_BATCHES]
    served = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    bs.bcsr_spmm.launches = 0  # the main path's run starts here
    for subs in requests:
        before = bs.bcsr_spmm.launches
        times = []
        outs = []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(pred(subs))
            times.append((time.perf_counter() - t0) * 1e3)
        check(bs.bcsr_spmm.launches - before == 2 * EM_USER["conv_layer"],
              f"kernel launches {bs.bcsr_spmm.launches - before} for two "
              f"requests of {EM_USER['conv_layer']} layer(s)")
        check(outs[0].shape == (len(subs), 1), f"logits shape {outs[0].shape}")
        check(np.isfinite(outs[0]).all(), "non-finite logits")
        check(np.array_equal(outs[0], outs[1]), "repeated request differs")
        served.append((subs, outs[0], times))
    launches = bs.bcsr_spmm.launches  # ... and ends here
    peak_gib = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else None)

    model_seg = em_user_model(max_deg, "segment", device)
    pred_seg = Predictor(model_seg, graph, feats, device=device)
    for subs, out, times in served:
        ref = pred_seg(subs)
        diff = float(np.abs(out - ref).max())
        scale = float(np.abs(ref).max())
        check(np.allclose(out, ref, rtol=1e-4, atol=1e-5 * scale),
              f"batch {len(subs)}: pallas vs segment max|diff| {diff}")
        emit("request", batch=len(subs), width=max(map(len, subs)),
             ms_first=times[0], ms_repeat=times[1],
             max_abs_diff_vs_segment=diff, max_abs_logit=scale)
    emit("main_path", requests=2 * len(served), kernel_launches=launches,
         peak_mem_gib=peak_gib)
    record["launches"] = launches
    return record


def phase_train_bcsr(device, record: dict, n_comm=N_COMM, csz=COMM_SIZE,
                     edges=UNDIRECTED_EDGES) -> None:
    """em_user trained at full width on the forced BCSR layout, f32: the
    BCSR backward at full scale (Trainer epochs with em_user's dropout,
    batch and lr, the recipe of phase_band_main), 2 BCSR launches per conv
    layer and step and no other SpMM kernel, finite and falling losses.
    Adds the launches to the BCSR kernel's record."""
    ei, n = clustered_graph(n_comm, csz, edges)
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="bcsr", device=device)
    check(graph.bcsr is not None and graph.bcsr_t is graph.bcsr
          and graph.band is None and graph.bcsr.blocks.dtype == torch.float32,
          "the em_user graph has no symmetric f32 BCSR layout")
    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    model = em_user_model(int(feats_np.max()), "pallas", device,
                          dropout=EM_USER["dropout"])
    rng = np.random.default_rng(15)
    pos, y = size_labelled_subgraphs(rng, TRAIN_SUBGRAPHS + EVAL_SUBGRAPHS,
                                     n_comm, csz)
    bsz = EM_USER["batch_size"]
    trainer = Trainer(model, graph, feats, TrainConfig(
        lr=EM_USER["lr"], resi=EM_USER["resi"], batch_size=bsz, loss="bce"))
    trainer.init(0)
    losses, steps, step_ms = [], 0, []
    reset_counts()  # the path starts here
    for _ in range(TRAIN_EPOCHS):
        pos_b, y_b = make_train_batches(rng, pos[:TRAIN_SUBGRAPHS],
                                        y[:TRAIN_SUBGRAPHS], bsz)
        t0 = time.perf_counter()
        res = trainer.train_epoch(pos_b, y_b)  # ends in a readback
        step_ms.append((time.perf_counter() - t0) * 1e3
                       / len(res.step_losses))
        losses.append(res.loss)
        steps += len(res.step_losses)
    got = launch_counts()  # ... and ends here
    launches = 2 * EM_USER["conv_layer"] * steps
    check(got == {"bcsr": {"float32": launches}, "band": {}, "dense_q": 0,
                  "norm": {}},
          f"launches {got}: expected {launches} f32 BCSR launches and no "
          "other SpMM kernel")
    check(np.isfinite(losses).all(), f"non-finite epoch losses {losses}")
    check(losses[-1] < losses[0], f"epoch losses did not fall: {losses}")
    emit("train_bcsr", epochs=len(losses), steps=steps, batch=bsz,
         dropout=EM_USER["dropout"], bcsr_launches=launches,
         launches_per_step=launches / steps, epoch_losses=losses,
         ms_per_step=step_ms,
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    record["launches_train"] = launches
    record["launches_per_step_train"] = launches / steps


# ------------------------------------------------------------ banded slabs

BAND_TPU = [
    "glass_tpu/ops/pallas_band.py:658 _band_kernel_affine",
    "glass_tpu/ops/pallas_band.py:465 _band_kernel",
    "glass_tpu/ops/pallas_band.py:505 _band_kernel_xvmem",
    "glass_tpu/ops/pallas_band.py:543 _band_kernel_xvmem_gps",
    "glass_tpu/ops/pallas_band.py:605 _band_kernel_gps",
    "glass_tpu/ops/pallas_band.py:793 _band_kernel_striped",
]


def piecewise_edges(rng, n):
    """Directed band whose window law jumps at half depth (the recipe of
    tests/test_pallas_band.py::_piecewise_directed): per-group windows stay
    narrow, one affine law would inflate them past the gate."""
    half = n // 2
    r1 = np.arange(half)
    c1 = np.clip(r1 + rng.integers(-48, 48, half), 0, n - 1)
    r2 = np.arange(half, n)
    c2 = np.clip(r2 - half + rng.integers(-48, 48, half), 0, n - 1)
    return np.stack([np.concatenate([r1, r2]), np.concatenate([c1, c2])])


def small_band_layouts(device, dense_dtype: str = "f32") -> dict:
    """name -> BandedAdj for the kernel's cases, with slabs of
    ``dense_dtype``'s type; fails if a layout lacks the case it stands
    for."""
    rng = np.random.default_rng(11)
    ei, n = clustered_graph(12, BLOCK, 6000, seed=5)
    kw = dict(materialize_dense=False, materialize_bcsr=True,
              sparse_layout="band", dense_dtype=dense_dtype, device=device)
    affine = build_graph(ei, None, n, "gcn", **kw).band
    top = affine.n_groups - 1
    check(affine.affine_stride is not None and affine.affine_off < 0
          and top * affine.affine_stride + affine.affine_off
          + affine.w_blocks > affine.n_cb,
          "the affine layout lacks a negative offset or a bottom overhang")

    n = 16 * BLOCK
    per_group = build_graph(piecewise_edges(rng, n), None, n, "sum",
                            **kw).band
    check(per_group.affine_stride is None, "the affine gate took the jump")

    n = 10 * BLOCK + 37
    r = rng.integers(0, n, 4000)
    r = r[(r // BLOCK < 2) | (r // BLOCK > 3)]  # group 1 of rps 2 is empty
    c = np.clip(r + rng.integers(-200, 200, r.size), 0, n - 1)
    w = rng.uniform(0.5, 2.0, r.size).astype(np.float32)
    empty = build_graph(np.stack([r, c]), w, n, "sum", band_rps=2,
                        **kw).band
    check(bool((empty.slabs != 0).flatten(1).any(dim=1).logical_not().any()),
          "the ragged layout has no empty group")
    return {"affine": affine, "per_group": per_group,
            "empty_groups_ragged": empty}


def nonzero_band_blocks(band) -> int:
    """128x128 blocks of the slabs that hold at least one nonzero (this
    data's work; the rest of the band is zeros)."""
    b = band.slabs.view(band.n_groups, band.rps, BLOCK, band.w_blocks, BLOCK)
    return int((b != 0).any(dim=4).any(dim=2).sum())


def band_args(band, x) -> tuple:
    """least_ms's arguments for a band layout: its nonzero blocks, the
    window table and the row scale."""
    return (nonzero_band_blocks(band), band.slabs,
            band.n_groups * 4 + scale_bytes(band), x, band.n_node)


def band_bound_ms(band, x) -> tuple:
    return least_ms(*band_args(band, x))


def wide_range_band(device):
    """An f32 band whose values span 2^-20 to 2^4 ("sum" keeps them)."""
    rng = np.random.default_rng(18)
    ei, n = clustered_graph(10, BLOCK, 5000, seed=9)
    w = np.exp2(rng.uniform(-20, 4, ei.shape[1])).astype(np.float32)
    band = build_graph(ei, w, n, "sum", materialize_dense=False,
                       materialize_bcsr=True, sparse_layout="band",
                       device=device).band
    nz = band.slabs[band.slabs != 0].abs()
    check(float(nz.min()) < 2.0 ** -18 and float(nz.max()) > 2.0 ** 2,
          "the wide-range layout does not span 2^-20 to 2^4")
    return band


def phase_band_small(device) -> None:
    gen = torch.Generator().manual_seed(12)
    layouts = small_band_layouts(device)
    layouts["wide_range"] = wide_range_band(device)
    for name, band in layouts.items():
        for xdt in X_DTYPES:  # bf16 x: widened exactly, loaded by the threads
            for h in (17, 64, 128):
                x = torch.randn(band.n_node, h, generator=gen).to(device, xdt)
                err, scale = check_vs_plain(
                    f"band {name} x {xdt} H={h}",
                    lambda v: bd.band_spmm(band, v),
                    lambda v: bd.band_spmm_reference(band, v), x)
                emit("kernel_band_small", layout=name, x=str(xdt), H=h,
                     n_node=band.n_node, rps=band.rps,
                     w_blocks=band.w_blocks,
                     affine_stride=band.affine_stride,
                     affine_off=band.affine_off, max_abs_err=err,
                     max_abs_ref=scale)


def phase_grad_small(device) -> None:
    """dx = A^T g through each kernel's autograd Function against the plain
    version's autograd, on an asymmetric graph."""
    gen = torch.Generator().manual_seed(13)
    ei, n = clustered_graph(12, BLOCK, 6000, seed=5)
    h = 64
    x = torch.randn(n, h, generator=gen).to(device)
    w = torch.randn(n, h, generator=gen).to(device)
    for layout in ("band", "bcsr"):
        g = build_graph(ei, None, n, "mean", materialize_dense=False,
                        materialize_bcsr=True, sparse_layout=layout,
                        device=device)
        if layout == "band":
            fwd, bwd, mod, plain = g.band, g.band_t, bd.band_spmm, \
                bd.band_spmm_reference
        else:
            fwd, bwd, mod, plain = g.bcsr, g.bcsr_t, bs.bcsr_spmm, \
                bs.bcsr_spmm_reference
        check(fwd is not None and bwd is not fwd,
              f"the mean graph's {layout} layout is not an asymmetric pair")
        before = mod.launches
        xk = x.clone().requires_grad_()
        (dx,) = torch.autograd.grad((mod(fwd, xk, bwd) * w).sum(), xk)
        launches = mod.launches - before
        xp = x.clone().requires_grad_()
        (dx_ref,) = torch.autograd.grad((plain(fwd, xp) * w).sum(), xp)
        torch.cuda.synchronize()
        err = float((dx - dx_ref).abs().max())
        scale = float(dx_ref.abs().max())
        check(launches == 2, f"{layout}: {launches} launches for fwd + bwd")
        check(err <= KERNEL_TOL * scale,
              f"{layout} dx vs plain autograd: max|diff| {err} > "
              f"{KERNEL_TOL} * {scale}")
        emit("grad_small", layout=layout, n_node=n, H=h, launches=launches,
             max_abs_err=err, max_abs_ref=scale)


def size_labelled_subgraphs(rng, count: int, n_comm: int, csz: int):
    """(pos, y): ``count`` subgraphs drawn like make_request, padded with
    -1, labelled 1 iff the subgraph has more nodes than the median."""
    subs = make_request(rng, count, n_comm, csz)
    sizes = np.array([len(s) for s in subs])
    pos = np.full((count, sizes.max()), -1, dtype=np.int64)
    for i, s in enumerate(subs):
        pos[i, : len(s)] = s
    return pos, (sizes > np.median(sizes)).astype(np.float32)


def small_training(device, layout: str, dense_dtype: str = "f32",
                   compute_dtype=None):
    """(step losses, parameters on the CPU) of a small GLASS (dropout 0)
    after one 3-step epoch on an asymmetric graph."""
    ei, n = clustered_graph(8, BLOCK, 3000, seed=6)
    graph = build_graph(ei, None, n, "mean", materialize_dense=False,
                        materialize_bcsr=True, sparse_layout=layout,
                        dense_dtype=dense_dtype, device=device)
    check((graph.band if layout == "band" else graph.bcsr) is not None,
          f"the small training graph has no {layout} layout")
    feats = np.random.default_rng(7).integers(0, 6, (n, 1))
    model = GLASS(5, 16, 2, (1,), ("size",), dropout=0.0,
                  spmm_mode="pallas", compute_dtype=compute_dtype, seed=0,
                  device=device)
    pos, y = size_labelled_subgraphs(np.random.default_rng(8), 18, 8, BLOCK)
    trainer = Trainer(model, graph, torch.from_numpy(feats).to(device),
                      TrainConfig(lr=EM_USER["lr"], batch_size=6, loss="bce"))
    trainer.init(0)
    pos_b, y_b = make_train_batches(np.random.default_rng(9), pos, y, 6)
    res = trainer.train_epoch(pos_b, y_b)
    return res.step_losses, {k: v.cpu() for k, v in model.state_dict().items()}


def phase_train_small(device) -> None:
    for layout in ("band", "bcsr"):
        losses, params = small_training(device, layout)
        losses_cpu, params_cpu = small_training(torch.device("cpu"), layout)
        loss_err = float(np.abs(losses - losses_cpu).max())
        param_err = max(float((params[k] - params_cpu[k]).abs().max())
                        for k in params)
        check(np.isfinite(losses).all(), f"{layout}: non-finite losses")
        check(np.allclose(losses, losses_cpu, rtol=TRAIN_LOSS_RTOL, atol=0),
              f"{layout}: card losses {losses} vs CPU {losses_cpu}")
        check(param_err <= TRAIN_PARAM_ATOL_LRS * EM_USER["lr"],
              f"{layout}: parameters differ by {param_err} after 3 steps")
        emit("train_small", layout=layout, steps=len(losses),
             losses=losses.tolist(), max_abs_loss_diff=loss_err,
             max_abs_param_diff=param_err)


def phase_band_main(device, n_comm=N_COMM, csz=COMM_SIZE,
                    edges=UNDIRECTED_EDGES) -> dict:
    """The em_user training path on the banded layout, then requests
    served on it. Returns the band kernel's record for the kernels line and
    the trained model's eval micro-F1."""
    gen = torch.Generator().manual_seed(14)
    ei, n = clustered_graph(n_comm, csz, edges)
    t0 = time.perf_counter()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="band", device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    band = graph.band
    check(band is not None and graph.band_t is band,
          "the em_user graph has no symmetric band layout")
    law = (band.rps, band.w_blocks, band.affine_stride, band.affine_off)
    check(law == EM_USER_BAND_LAW,
          f"(rps, w_blocks, stride, off) {law}, expected {EM_USER_BAND_LAW}")
    stored = band.n_groups * band.rps * band.w_blocks
    nz = nonzero_band_blocks(band)
    emit("graph_band", n_node=n, directed_edges=graph.n_edge, rps=band.rps,
         w_blocks=band.w_blocks, affine_stride=band.affine_stride,
         affine_off=band.affine_off, groups=band.n_groups,
         slab_bytes=band.slabs.numel() * 4, stored_blocks=stored,
         nonzero_blocks=nz, fill=nz / stored, build_s=build_s)

    h = EM_USER["hidden_dim"]
    for width in (17, 128):  # the f32 band at other widths of H
        w_err, w_scale = check_vs_plain(
            f"em_user band H={width}", lambda v: bd.band_spmm(band, v),
            lambda v: bd.band_spmm_reference(band, v),
            torch.randn(n, width, generator=gen).to(device))
        emit("kernel_band_main_width", H=width, max_abs_err=w_err,
             max_abs_ref=w_scale)
    x = torch.randn(n, h, generator=gen).to(device)
    err, scale = check_vs_plain("em_user band",
                                lambda v: bd.band_spmm(band, v),
                                lambda v: bd.band_spmm_reference(band, v), x)
    adj = csr_adjacency(graph)
    lib = torch.sparse.mm(adj, x)
    lib_err = float((lib - bd.band_spmm_reference(band, x)).abs().max())
    record = dict(
        name="band_spmm", route="cuda",
        source="glass_tpu_torch/csrc/band_spmm.cu",
        replaces="glass_tpu/ops/pallas_band.py:658", tpu=BAND_TPU,
        max_abs_err=err,
        **timed(lambda: bd.band_spmm(band, x),
                lambda: bd.band_spmm_reference(band, x),
                lambda: torch.sparse.mm(adj, x)),
    )
    record["bound_ms"], record["bound_by"] = band_bound_ms(band, x)
    emit("kernel_band_main", H=h, max_abs_err=err, max_abs_ref=scale,
         library_max_abs_diff=lib_err,
         bounds_by_reckoning=reckonings(*band_args(band, x)),
         **{k: record[k] for k in TIME_KEYS})
    del adj, lib, x

    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    max_deg = int(feats_np.max())
    model = em_user_model(max_deg, "pallas", device,
                          dropout=EM_USER["dropout"])
    rng = np.random.default_rng(15)
    pos, y = size_labelled_subgraphs(rng, TRAIN_SUBGRAPHS + EVAL_SUBGRAPHS,
                                     n_comm, csz)
    bsz = EM_USER["batch_size"]
    trainer = Trainer(model, graph, feats, TrainConfig(
        lr=EM_USER["lr"], resi=EM_USER["resi"], batch_size=bsz, loss="bce"))
    trainer.init(0)
    torch.cuda.reset_peak_memory_stats(device)
    epochs = []
    reset_counts()  # the path starts here
    for epoch in range(TRAIN_EPOCHS):
        pos_b, y_b = make_train_batches(rng, pos[:TRAIN_SUBGRAPHS],
                                        y[:TRAIN_SUBGRAPHS], bsz)
        t0 = time.perf_counter()
        res = trainer.train_epoch(pos_b, y_b)  # ends in a readback
        ms = (time.perf_counter() - t0) * 1e3
        epochs.append(dict(epoch=epoch, mean_loss=res.loss,
                           steps=len(res.step_losses),
                           ms_per_step=ms / len(res.step_losses)))
        emit("train_epoch", **epochs[-1])
    launches = bd.band_spmm.launches  # ... and ends here
    check(launch_counts() == {"bcsr": {}, "band": {"float32": launches},
                              "dense_q": 0, "norm": {}},
          f"the f32 band path launched other kernels: {launch_counts()}")
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    steps = sum(e["steps"] for e in epochs)
    losses = [e["mean_loss"] for e in epochs]
    check(np.isfinite(losses).all(), f"non-finite epoch losses {losses}")
    check(losses[-1] < losses[0], f"epoch losses did not fall: {losses}")
    check(launches == 2 * EM_USER["conv_layer"] * steps,
          f"{launches} band launches for {steps} steps of "
          f"{EM_USER['conv_layer']} conv layer(s)")
    pos_e, y_e, _ = make_eval_batches(pos[TRAIN_SUBGRAPHS:],
                                      y[TRAIN_SUBGRAPHS:], bsz)
    y_pad, mask = pad_eval_labels(y_e, pos_e.shape[0], bsz)
    score = trainer.evaluate_score(pos_e, y_pad, mask)
    emit("train", epochs=len(epochs), steps=steps, batch=bsz,
         dropout=EM_USER["dropout"], lr=EM_USER["lr"],
         band_launches=launches, launches_per_step=launches / steps,
         epoch_losses=losses, eval_micro_f1=score, peak_mem_gib=peak_gib)
    record["launches"] = launches
    record["launches_per_step"] = launches / steps

    pred = Predictor(model, graph, feats, device=device)
    model_seg = em_user_model(max_deg, "segment", device)
    model_seg.load_state_dict(model.state_dict())
    pred_seg = Predictor(model_seg, graph, feats, device=device)
    rng = np.random.default_rng(16)
    requests = [make_request(rng, b, n_comm, csz) for b in REQUEST_BATCHES]
    bd.band_spmm.launches = 0  # the serving path on the band starts here
    for subs in requests:
        before = bd.band_spmm.launches
        t0 = time.perf_counter()
        out = pred(subs)
        ms = (time.perf_counter() - t0) * 1e3
        again = pred(subs)
        check(bd.band_spmm.launches - before == 2 * EM_USER["conv_layer"],
              f"band launches {bd.band_spmm.launches - before} for two "
              f"requests of {EM_USER['conv_layer']} layer(s)")
        check(out.shape == (len(subs), 1) and np.isfinite(out).all(),
              f"band request logits {out.shape}, finite "
              f"{np.isfinite(out).all()}")
        check(np.array_equal(out, again), "repeated band request differs")
        ref = pred_seg(subs)
        diff = float(np.abs(out - ref).max())
        ref_scale = float(np.abs(ref).max())
        check(np.allclose(out, ref, rtol=1e-4, atol=1e-5 * ref_scale),
              f"band batch {len(subs)}: vs segment max|diff| {diff}")
        emit("request_band", batch=len(subs), width=max(map(len, subs)),
             ms_first=ms, max_abs_diff_vs_segment=diff,
             max_abs_logit=ref_scale)
    return record, score


# ---------------------------------------------------------- mixed precision

X_DTYPES = (torch.float32, torch.bfloat16)


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    bs.bcsr_spmm.launches = bd.band_spmm.launches = 0
    dq.dense_q_spmm.launches = fn.fused_graph_norm.launches = 0
    bs.bcsr_spmm.launches_by_dtype.clear()
    bd.band_spmm.launches_by_dtype.clear()
    fn.fused_graph_norm.launches_by_kernel.clear()
    fn.fused_graph_norm.launches_by_dtype.clear()


def launch_counts() -> dict:
    """The launch counts since reset_counts, by kernel and slab type; the
    fused GraphNorm's by pass."""
    return {"bcsr": dict(bs.bcsr_spmm.launches_by_dtype),
            "band": dict(bd.band_spmm.launches_by_dtype),
            "dense_q": dq.dense_q_spmm.launches,
            "norm": dict(fn.fused_graph_norm.launches_by_kernel)}


DENSE_ZERO_ROW = 5  # an isolated node: an all-zero row of the layout


def dense_q_graph(device, n=700, seed=22):
    """A random directed graph of n nodes under "mean" normalization with
    the int8 dense layout (A^T a layout of its own); node DENSE_ZERO_ROW
    has no edges."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, 8 * n))
    ei = ei[:, (ei != DENSE_ZERO_ROW).all(axis=0)]
    graph = build_graph(ei, None, n, "mean", materialize_dense=True,
                        dense_dtype="int8", device=device)
    check(graph.dense_q is not None and graph.dense_q_t is not graph.dense_q,
          "the small graph has no asymmetric int8 dense pair")
    check(not graph.dense_q.q[DENSE_ZERO_ROW].any(),
          "the small int8 dense layout has no all-zero row")
    return graph


def phase_kernel_q_small(device) -> None:
    """Every bf16 and int8 instantiation against its plain version."""
    gen = torch.Generator().manual_seed(21)
    for dd in ("bf16", "int8"):
        for name, band in small_band_layouts(device, dd).items():
            for xdt in X_DTYPES:
                for h in (17, 64, 128):
                    x = torch.randn(band.n_node, h, generator=gen).to(
                        device, xdt)
                    err, scale = check_vs_plain(
                        f"band {dd} {name} x {xdt} H={h}",
                        lambda v: bd.band_spmm(band, v),
                        lambda v: bd.band_spmm_reference(band, v), x)
                    emit("kernel_q_small", kernel="band", layout=name,
                         slabs=str(band.slabs.dtype), x=str(xdt), H=h,
                         max_abs_err=err, max_abs_ref=scale)
    ei, w, n = small_layout_edges()
    for dd in ("bf16", "int8"):
        bcsr = build_graph(ei, w, n, "sum", materialize_dense=False,
                           materialize_bcsr=True, sparse_layout="bcsr",
                           dense_dtype=dd, device=device).bcsr
        for xdt in X_DTYPES:
            for h in (17, 128):
                x = torch.randn(n, h, generator=gen).to(device, xdt)
                err, scale = check_vs_plain(
                    f"bcsr {dd} x {xdt} H={h}",
                    lambda v: bs.bcsr_spmm(bcsr, v),
                    lambda v: bs.bcsr_spmm_reference(bcsr, v), x)
                emit("kernel_q_small", kernel="bcsr",
                     blocks=str(bcsr.blocks.dtype), x=str(xdt), H=h,
                     max_abs_err=err, max_abs_ref=scale)
    for n in (700, 1100):  # n % 128 != 0, an all-zero row
        layout = dense_q_graph(device, n).dense_q
        for xdt in X_DTYPES:
            for h in (17, 64, 200):  # 200: four column tiles
                x = torch.randn(n, h, generator=gen).to(device, xdt)
                err, scale = check_vs_plain(
                    f"dense_q n={n} x {xdt} H={h}",
                    lambda v: dq.dense_q_spmm(layout, None, v),
                    lambda v: dq.dense_q_spmm_reference(layout, v), x)
                emit("kernel_q_small", kernel="dense_q", n_node=n,
                     x=str(xdt), H=h, max_abs_err=err, max_abs_ref=scale)


def phase_grad_q_small(device) -> None:
    """dx through each autograd Function on an asymmetric graph against the
    plain version over the transposed layout, in x's dtype: within
    KERNEL_TOL * max for f32 x; for bf16 x also one bf16 ulp of each value
    (the same f32 sum, taken in another order, may round to the
    neighbouring bf16 value)."""
    gen = torch.Generator().manual_seed(23)
    ei, n = clustered_graph(12, BLOCK, 6000, seed=5)
    h = 64
    w = torch.randn(n, h, generator=gen).to(device)
    for layout, dd in (("band", "int8"), ("band", "bf16"), ("bcsr", "int8"),
                       ("bcsr", "bf16"), ("dense", "int8")):
        kw = (dict(materialize_dense=True) if layout == "dense" else
              dict(materialize_dense=False, materialize_bcsr=True,
                   sparse_layout=layout))
        g = build_graph(ei, None, n, "mean", dense_dtype=dd, device=device,
                        **kw)
        fwd, bwd, fn, plain = {
            "band": (g.band, g.band_t, bd.band_spmm, bd.band_spmm_reference),
            "bcsr": (g.bcsr, g.bcsr_t, bs.bcsr_spmm, bs.bcsr_spmm_reference),
            "dense": (g.dense_q, g.dense_q_t,
                      lambda a, v, a_t: dq.dense_q_spmm(a, a_t, v),
                      dq.dense_q_spmm_reference)}[layout]
        check(fwd is not None and bwd is not fwd,
              f"the mean graph's {layout} {dd} layout is not an asymmetric "
              "pair")
        for xdt in X_DTYPES:
            x = torch.randn(n, h, generator=gen).to(device, xdt)
            reset_counts()
            xk = x.clone().requires_grad_()
            (dx,) = torch.autograd.grad((fn(fwd, xk, bwd) * w).sum(), xk)
            c = launch_counts()
            launches = sum(c["band"].values()) + sum(c["bcsr"].values()) \
                + c["dense_q"]
            dx_ref = plain(bwd, w).to(xdt)
            sync(device)
            err = float((dx.float() - dx_ref.float()).abs().max())
            scale = float(dx_ref.float().abs().max())
            tol = KERNEL_TOL * scale
            if xdt == torch.bfloat16:
                tol = tol + 2.0 ** -8 * dx_ref.float().abs()
            check(dx.dtype == xdt, f"{layout} {dd}: dx of {dx.dtype}")
            check(launches == 2, f"{layout} {dd}: {launches} launches")
            check(bool(((dx.float() - dx_ref.float()).abs() <= tol).all()),
                  f"{layout} {dd} x {xdt}: dx vs plain max|diff| {err}")
            emit("grad_q_small", layout=layout, adjacency=dd, x=str(xdt),
                 n_node=n, H=h, launches=launches, max_abs_err=err,
                 max_abs_ref=scale)


def phase_train_q_small(device) -> None:
    """3 steps with bf16 compute, card vs CPU, on int8 and bf16 layouts."""
    for layout, dd in (("band", "int8"), ("bcsr", "bf16")):
        losses, params = small_training(device, layout, dd, "bfloat16")
        losses_cpu, params_cpu = small_training(torch.device("cpu"), layout,
                                                dd, "bfloat16")
        loss_err = float(np.abs(losses - losses_cpu).max())
        param_err = max(float((params[k] - params_cpu[k]).abs().max())
                        for k in params)
        check(np.isfinite(losses).all(), f"{layout} {dd}: non-finite losses")
        check(np.allclose(losses, losses_cpu, rtol=TRAIN_Q_LOSS_RTOL, atol=0),
              f"{layout} {dd}: card losses {losses} vs CPU {losses_cpu}")
        check(param_err <= TRAIN_PARAM_ATOL_LRS * EM_USER["lr"],
              f"{layout} {dd}: parameters differ by {param_err}")
        check(all(v.dtype == torch.float32 for v in params.values()),
              "a parameter left f32")
        emit("train_q_small", layout=layout, adjacency=dd,
             compute="bfloat16", steps=len(losses), losses=losses.tolist(),
             max_abs_loss_diff=loss_err, max_abs_param_diff=param_err)


def kernel_record(name: str, source: str, replaces: str, tpu: list, fn,
                  plain, library, x, bound: tuple, err: float) -> dict:
    """A kernels-line record: the kernel, its plain version and the library
    call timed on x (``timed``)."""
    rec = dict(name=name, route="cuda", source=source, replaces=replaces,
               tpu=tpu, max_abs_err=err,
               **timed(lambda: fn(x), lambda: plain(x), lambda: library(x)))
    rec["bound_ms"], rec["bound_by"] = bound
    return rec


def serve_requests(pred, requests, expect: dict, per_request: int) -> tuple:
    """Serves each request twice (checked bit-identical) with the launch
    counts reset before and read after; fails unless the counts are
    ``expect`` scaled to ``per_request`` launches per request. Returns
    (served (subs, logits, first ms) list, launches)."""
    served = []
    reset_counts()  # the serving path starts here
    for subs in requests:
        t0 = time.perf_counter()
        out = pred(subs)
        ms = (time.perf_counter() - t0) * 1e3
        again = pred(subs)
        check(out.shape == (len(subs), 1) and out.dtype == np.float32
              and np.isfinite(out).all(),
              f"request logits {out.shape} {out.dtype}")
        check(np.array_equal(out, again), "repeated request differs")
        served.append((subs, out, ms))
    launches = 2 * len(requests) * per_request
    got = launch_counts()  # ... and ends here
    want = {"bcsr": {}, "band": {}, "dense_q": 0, "norm": {}}
    want.update({k: ({v: launches} if isinstance(v, str) else launches)
                 for k, v in expect.items()})
    check(got == want, f"serving launches {got}, expected {want}")
    return served, launches


def phase_band_q_main(device, f32_score: float, n_comm=N_COMM, csz=COMM_SIZE,
                      edges=UNDIRECTED_EDGES) -> dict:
    """em_user with dense_dtype "int8" and compute_dtype "bfloat16" on the
    stand-in: the layout, the int8 band kernel at its training shape,
    training and requests. Returns the kernel's record."""
    gen = torch.Generator().manual_seed(24)
    ei, n = clustered_graph(n_comm, csz, edges)
    t0 = time.perf_counter()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="band", dense_dtype="int8",
                        device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    band = graph.band
    check(band is not None and graph.band_t is band
          and band.slabs.dtype == torch.int8,
          "the em_user graph has no symmetric int8 band layout")
    law = (band.rps, band.w_blocks, band.affine_stride, band.affine_off)
    check(law == EM_USER_BAND_LAW,
          f"(rps, w_blocks, stride, off) {law}, expected {EM_USER_BAND_LAW}")
    nz = nonzero_band_blocks(band)
    emit("graph_band_q", n_node=n, rps=band.rps, w_blocks=band.w_blocks,
         affine_stride=band.affine_stride, affine_off=band.affine_off,
         groups=band.n_groups, slab_bytes=band.slabs.numel(),
         scale_bytes=scale_bytes(band), nonzero_blocks=nz, build_s=build_s)

    h = EM_USER["hidden_dim"]
    x = torch.randn(n, h, generator=gen).to(device, torch.bfloat16)
    err, scale = check_vs_plain("em_user int8 band",
                                lambda v: bd.band_spmm(band, v),
                                lambda v: bd.band_spmm_reference(band, v), x)
    adj = csr_adjacency(graph)
    record = kernel_record(
        "band_spmm_int8", "glass_tpu_torch/csrc/band_spmm.cu",
        "glass_tpu/ops/pallas_band.py:714",
        ["glass_tpu/ops/pallas_band.py:714 _band_kernel_affine_q"],
        lambda v: bd.band_spmm(band, v),
        lambda v: bd.band_spmm_reference(band, v),
        lambda v: torch.sparse.mm(adj, v.float()), x,
        band_bound_ms(band, x), err)
    emit("kernel_band_q_main", H=h, x="bfloat16", max_abs_err=err,
         max_abs_ref=scale, **{k: record[k] for k in TIME_KEYS})
    del adj, x

    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    max_deg = int(feats_np.max())
    model = em_user_model(max_deg, "pallas", device,
                          dropout=EM_USER["dropout"], compute_dtype="bfloat16")
    rng = np.random.default_rng(15)  # the f32 run's subgraphs and batches
    pos, y = size_labelled_subgraphs(rng, TRAIN_SUBGRAPHS + EVAL_SUBGRAPHS,
                                     n_comm, csz)
    bsz = EM_USER["batch_size"]
    trainer = Trainer(model, graph, feats, TrainConfig(
        lr=EM_USER["lr"], resi=EM_USER["resi"], batch_size=bsz, loss="bce"))
    trainer.init(0)
    torch.cuda.reset_peak_memory_stats(device)
    losses, steps, step_ms = [], 0, []
    reset_counts()  # the path starts here
    for epoch in range(TRAIN_EPOCHS):
        pos_b, y_b = make_train_batches(rng, pos[:TRAIN_SUBGRAPHS],
                                        y[:TRAIN_SUBGRAPHS], bsz)
        t0 = time.perf_counter()
        res = trainer.train_epoch(pos_b, y_b)
        step_ms.append((time.perf_counter() - t0) * 1e3
                       / len(res.step_losses))
        losses.append(res.loss)
        steps += len(res.step_losses)
        emit("train_q_epoch", epoch=epoch, mean_loss=res.loss,
             steps=len(res.step_losses), ms_per_step=step_ms[-1])
    got = launch_counts()  # ... and ends here
    launches = 2 * EM_USER["conv_layer"] * steps
    check(got == {"bcsr": {}, "band": {"int8": launches}, "dense_q": 0,
                  "norm": {}},
          f"launches {got}: expected {launches} int8-band launches and "
          "no other SpMM kernel")
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    check(np.isfinite(losses).all(), f"non-finite epoch losses {losses}")
    check(losses[-1] < losses[0], f"epoch losses did not fall: {losses}")
    pos_e, y_e, _ = make_eval_batches(pos[TRAIN_SUBGRAPHS:],
                                      y[TRAIN_SUBGRAPHS:], bsz)
    y_pad, mask = pad_eval_labels(y_e, pos_e.shape[0], bsz)
    score = trainer.evaluate_score(pos_e, y_pad, mask)
    emit("train_q", adjacency="int8", compute="bfloat16", epochs=len(losses),
         steps=steps, int8_band_launches=launches,
         launches_per_step=launches / steps, epoch_losses=losses,
         ms_per_step=step_ms, eval_micro_f1=score,
         f32_eval_micro_f1=f32_score, peak_mem_gib=peak_gib)
    record["launches"] = launches
    record["launches_per_step"] = launches / steps

    pred = Predictor(model, graph, feats, device=device)
    model_seg = em_user_model(max_deg, "segment", device)
    model_seg.load_state_dict(model.state_dict())
    pred_seg = Predictor(model_seg, graph, feats, device=device)
    requests = [make_request(np.random.default_rng(16), b, n_comm, csz)
                for b in REQUEST_BATCHES]
    served, _ = serve_requests(pred, requests, {"band": "int8"},
                               EM_USER["conv_layer"])
    for subs, out, ms in served:
        ref = pred_seg(subs)
        diff = float(np.abs(out - ref).max())
        check(np.allclose(out, ref, rtol=QUANT_RTOL, atol=QUANT_ATOL),
              f"int8/bf16 batch {len(subs)} vs f32 segment: max|diff| {diff}")
        emit("request_band_q", batch=len(subs), width=max(map(len, subs)),
             ms_first=ms, max_abs_diff_vs_f32_segment=diff,
             max_abs_logit=float(np.abs(ref).max()))
    return record


def phase_q_layouts_main(device, n_comm=N_COMM, csz=COMM_SIZE,
                         edges=UNDIRECTED_EDGES) -> list:
    """The bf16 band and the int8 BCSR layouts at the em_user shape: each
    kernel against its plain version and timed, then requests of a bf16
    model served on the layout. Returns the two kernels' records."""
    gen = torch.Generator().manual_seed(25)
    ei, n = clustered_graph(n_comm, csz, edges)
    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    h = EM_USER["hidden_dim"]
    records = []
    for layout, dd, name, replaces, tpu in (
            ("band", "bf16", "band_spmm_bf16",
             "glass_tpu/ops/pallas_band.py:658", BAND_TPU),
            ("bcsr", "int8", "bcsr_spmm_int8",
             "glass_tpu/ops/pallas_spmm.py:411",
             ["glass_tpu/ops/pallas_spmm.py:321 _bcsr_chunk_kernel",
              "glass_tpu/ops/pallas_spmm.py:411 _bcsr_chunk_kernel_large"])):
        graph = build_graph(ei, None, n, EM_USER["aggr"],
                            materialize_bcsr=True, sparse_layout=layout,
                            dense_dtype=dd, device=device)
        held = graph.band if layout == "band" else graph.bcsr
        want = torch.bfloat16 if dd == "bf16" else torch.int8
        check(held is not None and (held.slabs if layout == "band"
                                    else held.blocks).dtype == want,
              f"the em_user graph has no {dd} {layout} layout")
        check(layout != "band" or (held.rps, held.w_blocks, held.affine_stride,
                                   held.affine_off) == EM_USER_BAND_LAW,
              f"the {dd} band is not the planner's {EM_USER_BAND_LAW}")
        fn = bd.band_spmm if layout == "band" else bs.bcsr_spmm
        plain = (bd.band_spmm_reference if layout == "band"
                 else bs.bcsr_spmm_reference)
        x = torch.randn(n, h, generator=gen).to(device, torch.bfloat16)
        err, scale = check_vs_plain(f"em_user {dd} {layout}",
                                    lambda v: fn(held, v),
                                    lambda v: plain(held, v), x)
        adj = csr_adjacency(graph)
        bound = (band_bound_ms(held, x) if layout == "band"
                 else bound_ms(held, x))
        rec = kernel_record(
            name, f"glass_tpu_torch/csrc/{layout}_spmm.cu", replaces, tpu,
            lambda v: fn(held, v),
            lambda v: plain(held, v), lambda v: torch.sparse.mm(adj, v.float()),
            x, bound, err)
        emit(f"kernel_{layout}_{dd}_main", H=h, x="bfloat16",
             max_abs_err=err, max_abs_ref=scale,
             **{k: rec[k] for k in TIME_KEYS})
        del adj, x
        model = em_user_model(int(feats_np.max()), "pallas", device,
                              compute_dtype="bfloat16")
        pred = Predictor(model, graph, feats, device=device)
        requests = [make_request(np.random.default_rng(17), b, n_comm, csz)
                    for b in REQUEST_BATCHES]
        served, rec["launches"] = serve_requests(
            pred, requests, {layout: "bfloat16" if dd == "bf16" else "int8"},
            EM_USER["conv_layer"])
        for subs, out, ms in served:
            emit(f"request_{layout}_{dd}", batch=len(subs), ms_first=ms,
                 max_abs_logit=float(np.abs(out).max()))
        records.append(rec)
        del graph, held, pred, model
    return records


def hpo_graph(n=HPO_NODES, e_directed=HPO_DIRECTED_EDGES):
    """Unstructured random graph at the hpo_metab scale, the recipe of
    bench.py::hpo_graph. Returns (edge_index, n)."""
    rng = np.random.default_rng(7)
    e = e_directed // 2
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e)
    return np.stack([np.concatenate([src, dst]),
                     np.concatenate([dst, src])]), n


def class_labelled_subgraphs(rng, count: int, n: int, classes: int):
    """(pos, y): ``count`` random node sets of 4-64 nodes, padded with -1,
    labelled by size into ``classes`` equal-count bins."""
    sizes = rng.integers(4, 65, count)
    pos = np.full((count, sizes.max()), -1, dtype=np.int64)
    for i, k in enumerate(sizes):
        pos[i, :k] = rng.choice(n, k, replace=False)
    edges = np.quantile(sizes, np.linspace(0, 1, classes + 1)[1:-1])
    return pos, np.digitize(sizes, edges).astype(np.int64)


def phase_dense_q_main(device) -> dict:
    """The dense route at hpo scale with dense_dtype "int8": the layout,
    the kernel at its training shape beside torch.matmul of q's bf16 copy,
    and training with hpo_metab's settings. Returns the kernel's record."""
    gen = torch.Generator().manual_seed(26)
    ei, n = hpo_graph()
    t0 = time.perf_counter()
    graph = build_graph(ei, None, n, HPO_METAB["aggr"], materialize_dense=True,
                        dense_dtype="int8", device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    layout = graph.dense_q
    check(graph.dense is None and layout is not None
          and graph.dense_q_t is layout,
          "the hpo graph has no symmetric int8 dense layout")
    n_rp, n_cp = layout.q.shape[0] // BLOCK, layout.q.shape[1] // BLOCK
    nz = int((layout.q.view(n_rp, BLOCK, n_cp, BLOCK) != 0)
             .any(dim=3).any(dim=1).sum())
    h = HPO_METAB["hidden_dim"]
    emit("graph_dense_q", n_node=n, directed_edges=graph.n_edge,
         q_bytes=layout.q.numel(), nonzero_blocks=nz, blocks=n_rp * n_cp,
         build_s=build_s)

    x = torch.randn(n, h, generator=gen).to(device)  # f32 compute
    err, scale = check_vs_plain(
        "hpo dense_q", lambda v: dq.dense_q_spmm(layout, None, v),
        lambda v: dq.dense_q_spmm_reference(layout, v), x)
    q_bf16 = layout.q.to(torch.bfloat16)

    def library(v):
        v_pad = v.new_zeros((layout.q.shape[1], h), dtype=torch.bfloat16)
        v_pad[:n] = v
        return torch.matmul(q_bf16, v_pad) * layout.scale[:, None]

    record = kernel_record(
        "dense_q_spmm", "glass_tpu_torch/csrc/dense_q_spmm.cu",
        "glass_tpu/ops/pallas_dense.py:82",
        ["glass_tpu/ops/pallas_dense.py:82 _kernel"],
        lambda v: dq.dense_q_spmm(layout, None, v),
        lambda v: dq.dense_q_spmm_reference(layout, v), library, x,
        least_ms(nz, layout.q, layout.scale.numel() * 4, x, n), err)
    lib_err = float((library(x)[:n] - dq.dense_q_spmm_reference(layout, x))
                    .abs().max())
    emit("kernel_dense_q_main", H=h, x="float32",
         max_abs_err=err, max_abs_ref=scale, library_max_abs_diff=lib_err,
         **{k: record[k] for k in TIME_KEYS})
    del q_bf16, x

    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    model = GLASS(int(feats_np.max()), h, HPO_METAB["conv_layer"],
                  (HPO_CLASSES,), (HPO_METAB["pool"],),
                  activation=HPO_METAB["activation"],
                  z_ratio=HPO_METAB["z_ratio"], jk=HPO_METAB["jk"],
                  dropout=HPO_METAB["dropout"], spmm_mode="dense", seed=0,
                  device=device)
    rng = np.random.default_rng(27)
    pos, y = class_labelled_subgraphs(rng, HPO_SUBGRAPHS, n, HPO_CLASSES)
    bsz = HPO_METAB["batch_size"]
    trainer = Trainer(model, graph, feats, TrainConfig(
        lr=HPO_METAB["lr"], resi=HPO_METAB["resi"], batch_size=bsz,
        loss="ce"))
    trainer.init(0)
    torch.cuda.reset_peak_memory_stats(device)
    losses, steps, step_ms = [], 0, []
    reset_counts()  # the path starts here
    for epoch in range(HPO_EPOCHS):
        pos_b, y_b = make_train_batches(rng, pos, y, bsz)
        t0 = time.perf_counter()
        res = trainer.train_epoch(pos_b, y_b)
        step_ms.append((time.perf_counter() - t0) * 1e3
                       / len(res.step_losses))
        losses.append(res.loss)
        steps += len(res.step_losses)
    got = launch_counts()  # ... and ends here
    launches = 2 * HPO_METAB["conv_layer"] * steps
    check(got == {"bcsr": {}, "band": {}, "dense_q": launches, "norm": {}},
          f"launches {got}: expected {launches} dense_q launches only")
    check(np.isfinite(losses).all(), f"non-finite epoch losses {losses}")
    emit("train_dense_q", epochs=len(losses), steps=steps, batch=bsz,
         classes=HPO_CLASSES, loss="ce", dense_q_launches=launches,
         launches_per_step=launches / steps, epoch_losses=losses,
         ms_per_step=step_ms,
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    record["launches"] = launches
    record["launches_per_step"] = launches / steps
    return record


# ------------------------------------------------------- fused GraphNorm

# each pass's TPU kernel (glass_tpu/ops/pallas_norm.py)
NORM_TPU = {
    "colsum": "glass_tpu/ops/pallas_norm.py:61 _colsum_kernel",
    "varsum": "glass_tpu/ops/pallas_norm.py:71 _varsum_kernel",
    "affine": "glass_tpu/ops/pallas_norm.py:86 _affine_kernel",
    "bwd_reduce": "glass_tpu/ops/pallas_norm.py:92 _bwd_reduce_kernel",
    "bwd_dx": "glass_tpu/ops/pallas_norm.py:106 _bwd_dx_kernel",
}
# the fused norm's gradients against the plain Function's and the unfused
# graph_norm's: sums in another order feed s^3-scaled terms, so 1e-4 *
# max|ref| (tests/test_torch_fused_norm.py's VJP tolerance)
NORM_GRAD_TOL = 1e-4
# a zero-variance column (s = rsqrt(eps) ~ 316 amplifies the rounding of
# c - alpha*mu): its values are rounding noise, held within 2e-3 * max|ref|
# of the whole tensor, the bound measured on the CPU against the JAX
# package (tests/test_torch_fused_norm.py, at most 6.7e-4 there)
ZERO_VAR_TOL = 2e-3
ZERO_VAR_COL = 3
BF16_ULP = 2.0 ** -7
NORM_SMALL_N, NORM_SMALL_F = (1, 1000, 3001), (17, 64, 200)


@contextlib.contextmanager
def fused_norm(on: bool):
    """GLASS_TPU_FUSED_NORM set to "1" or "0" inside the block."""
    old = os.environ.get("GLASS_TPU_FUSED_NORM")
    os.environ["GLASS_TPU_FUSED_NORM"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("GLASS_TPU_FUSED_NORM")
        else:
            os.environ["GLASS_TPU_FUSED_NORM"] = old


def norm_case(gen, n: int, f: int, dtype, device):
    """(x, dy, three (F,) f32 vectors) with x ~ 3 N(0, 1) + 1.5 and one
    constant column (ZERO_VAR_COL) where F has it."""
    x = torch.randn(n, f, generator=gen) * 3 + 1.5
    if f > ZERO_VAR_COL:
        x[:, ZERO_VAR_COL] = 2.7
    dy = torch.randn(n, f, generator=gen)
    vecs = [torch.randn(f, generator=gen).to(device) for _ in range(3)]
    return x.to(device, dtype), dy.to(device, dtype), vecs


def pass_args(kernel: str, x, dy, v) -> tuple:
    return {"colsum": (x,), "varsum": (x, v[0]), "affine": (x, v[0], v[1]),
            "bwd_reduce": (dy, x, v[0]), "bwd_dx": (dy, x, *v)}[kernel]


def check_pass(what: str, kernel: str, args) -> tuple:
    """(max |kernel - plain|, max |plain|) of one pass; fails past
    KERNEL_TOL * max|plain|, on a non-finite value, a dtype or shape
    mismatch, or if a repeated call differs in any bit."""
    run, plain = getattr(fn, kernel), getattr(fn, f"{kernel}_reference")
    out, again, ref = run(*args), run(*args), plain(*args)
    out, again, ref = ((t if isinstance(t, tuple) else (t,))
                       for t in (out, again, ref))
    torch.cuda.synchronize()
    err = scale = 0.0
    for o, a, r in zip(out, again, ref):
        check(o.dtype == r.dtype and o.shape == r.shape,
              f"{what}: output {o.dtype} {tuple(o.shape)}")
        check(torch.isfinite(o.float()).all().item(), f"{what}: non-finite")
        check(torch.equal(o, a), f"{what}: repeated call differs")
        err = max(err, float((o.float() - r.float()).abs().max()))
        scale = max(scale, float(r.float().abs().max()))
    check(err <= KERNEL_TOL * scale,
          f"{what}: max|diff| {err} > {KERNEL_TOL} * {scale}")
    return err, scale


def norm_run(norm, x, w, b, a, g) -> list:
    """[y, dx, dw, db, dalpha] as f32 of norm(x, w, b, a) under the loss
    sum(y * g): the cotangent is g in y's dtype whatever y's rounding."""
    xk = x.clone().requires_grad_()
    params = [p.clone().requires_grad_() for p in (w, b, a)]
    y = norm(xk, *params)
    grads = torch.autograd.grad((y.float() * g).sum(), [xk, *params])
    check(y.dtype == x.dtype and grads[0].dtype == x.dtype,
          f"fused norm: y {y.dtype}, dx {grads[0].dtype} for x {x.dtype}")
    return [y.detach().float()] + [g.float() for g in grads]


def check_norm_function(what: str, x, gen) -> dict:
    """The autograd Function on the kernels against the plain Function and
    the unfused graph_norm's autograd, under a random cotangent: y and dx
    within KERNEL_TOL (f32; against graph_norm NORM_GRAD_TOL, another
    formula's rounding) or, for bf16, one bf16 ulp of the larger value plus
    NORM_GRAD_TOL * max (f32 values that differ in their last bits round to
    neighbouring bf16 values); dw, db and dalpha within NORM_GRAD_TOL *
    max; the zero-variance column within ZERO_VAR_TOL * max. At N = 1
    every column holds only the variance that the mean scale leaves,
    x - alpha*x, and the two formulas cancel apart: against graph_norm, dx
    (a*dy + c2*x + c1, whose terms reach max|w*s*dy| and cancel to near 0)
    is held within 1e-5 of that term scale, the other outputs within
    ZERO_VAR_TOL * max in every column (measured on the CPU at most
    7.8e-4), each plus one bf16 ulp for bf16 x. Returns the worst relative
    differences."""
    f = x.shape[1]
    w, b = (torch.randn(f, generator=gen).to(x.device) for _ in range(2))
    a = (torch.randn(f, generator=gen) * 0.3 + 1).to(x.device)
    if f > ZERO_VAR_COL:
        a[ZERO_VAR_COL] = 1.0
    g = torch.randn(x.shape, generator=gen).to(x.device)
    got = norm_run(fn.fused_graph_norm, x, w, b, a, g)
    keep = torch.arange(f, device=x.device) != ZERO_VAR_COL
    xf = x.float()
    s = torch.rsqrt(((xf - a * xf.mean(0)) ** 2).mean(0) + 1e-5)
    dx_terms = float((w.abs() * s).max() * g.abs().max())
    worst = {}
    for ref_name, ref_fn in (("plain", fn.fused_graph_norm_reference),
                             ("unfused", graph_norm)):
        ref = norm_run(ref_fn, x, w, b, a, g)
        for i, (name, o, r) in enumerate(zip(("y", "dx", "dw", "db", "dalpha"),
                                             got, ref)):
            check(bool(torch.isfinite(o).all()), f"{what}: non-finite {name}")
            diff = (o - r).abs()
            big = float(r[..., keep].abs().max()) if keep.any() else 0.0
            if ref_name == "unfused" and x.shape[0] == 1:
                ulp = BF16_ULP * r.abs() if x.dtype == torch.bfloat16 else 0
                bound = (1e-5 * dx_terms if name == "dx"
                         else ZERO_VAR_TOL * float(r.abs().max()))
                ok = diff <= bound + ulp
            elif i < 2 and x.dtype == torch.bfloat16:
                ok = diff[..., keep] <= BF16_ULP * torch.maximum(
                    r[..., keep].abs(), o[..., keep].abs()) \
                    + NORM_GRAD_TOL * big
            else:
                tol = KERNEL_TOL if i < 2 and ref_name == "plain" \
                    else NORM_GRAD_TOL
                ok = diff[..., keep] <= tol * big + 1e-30
            check(bool(ok.all()), f"{what} {name} vs {ref_name}: max|diff| "
                  f"{float(diff[..., keep].max())} (max|ref| {big})")
            if f > ZERO_VAR_COL:
                zv = float(diff[..., ZERO_VAR_COL].max())
                check(zv <= ZERO_VAR_TOL * float(r.abs().max()),
                      f"{what} {name} vs {ref_name}: zero-variance column "
                      f"max|diff| {zv}")
                worst[f"{name}_vs_{ref_name}_zero_var_col"] = zv / max(
                    float(r.abs().max()), 1e-30)
            worst[f"{name}_vs_{ref_name}"] = float(diff[..., keep].max()) / \
                max(big, 1e-30)
    return worst


def phase_kernel_norm_small(device) -> None:
    """K1-K5 against their plain versions, and the autograd Function
    against the plain Function and graph_norm, at N in NORM_SMALL_N, F in
    NORM_SMALL_F, f32 and bf16 x with a zero-variance column."""
    gen = torch.Generator().manual_seed(31)
    for dtype in X_DTYPES:
        for n in NORM_SMALL_N:
            for f in NORM_SMALL_F:
                x, dy, v = norm_case(gen, n, f, dtype, device)
                errs = {}
                for k in fn.KERNELS:
                    err, scale = check_pass(f"{k} {dtype} {n}x{f}", k,
                                            pass_args(k, x, dy, v))
                    errs[k] = [err, scale]
                worst = check_norm_function(f"fused norm {dtype} {n}x{f}", x,
                                            gen)
                emit("kernel_norm_small", x=str(dtype), N=n, F=f,
                     max_abs_err_and_ref=errs, function_rel_diff=worst)


def norm_bound_ms(kernel: str, x) -> tuple:
    """(least ms, "bytes" | "operations") of one pass at x's shape: each
    (N, F) input read once and each output written once at x's itemsize,
    the (F,) f32 vectors and sums once; the f32 operations per element
    (K1 1, K2 3, K3 2, K4 4, K5 5) at the f32 rate."""
    n, f = x.shape
    big = n * f * x.element_size()
    vec = f * 4
    nbytes, ops = {
        "colsum": (big + vec, 1), "varsum": (big + 2 * vec, 3),
        "affine": (2 * big + 2 * vec, 2), "bwd_reduce": (2 * big + 3 * vec, 4),
        "bwd_dx": (3 * big + 3 * vec, 5)}[kernel]
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    t_ops = ops * n * f / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def norm_library(kernel: str, dtype):
    """(one PyTorch call computing the pass, or None, and why)."""
    if kernel == "colsum":
        return ((lambda x: x.sum(0)) if dtype == torch.float32 else
                (lambda x: x.sum(0, dtype=torch.float32))), "torch.sum"
    if kernel == "affine" and dtype == torch.float32:
        return (lambda x, g, h: torch.addcmul(h, x, g)), "torch.addcmul"
    if kernel == "affine":
        return None, "no single call: addcmul promotes bf16 x to f32"
    return None, "no single call"


L2_FLUSH_BYTES = 128 << 20  # past the H100's 50 MB L2
HEAD_START_CYCLES = 4_000_000  # about 2 ms of the card's clock


def device_ms(fn, reps: int = 20) -> tuple:
    """(device ms per call, {kernel: device us per call}) of ``fn()``: the
    CUDA kernels' own time from torch.profiler over ``reps`` calls, without
    the host's gaps between launches (which CUDA events around a run of
    short calls would include). Each call finds the L2 cache cold, as a
    training step's pass finds it after the other passes: a 128 MB fill
    runs before each call, and its kernel is left out of the sum."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and "FillFunctor" not in e.key
               and not getattr(e, "is_user_annotation", False)]
    check(kernels, "the profiler saw no device kernel")
    return (sum(e.self_device_time_total for e in kernels) / reps / 1e3,
            {e.key[:60]: e.self_device_time_total / reps for e in kernels})


def cold_ms(fn, reps: int = 20) -> float:
    """Device ms of one ``fn()`` with the L2 cache cold, the median over
    ``reps`` calls. Before each call a 128 MB fill evicts the L2 (as a
    training step's pass finds it after the other passes) and a spin kernel
    of about 2 ms (torch.cuda._sleep) holds the stream while the host
    enqueues the call between two CUDA events, so that the events time the
    call's kernels back to back: without the host's work, which time_ms
    includes where the card outruns it, and without operands left in L2 by
    the call before."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in spans)


def profile_norm(norm, x, w, b, a, g, reps: int = 3) -> dict:
    """Device kernels and their time per forward + backward of one norm,
    from torch.profiler over ``reps`` runs."""
    norm_run(norm, x, w, b, a, g)  # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            norm_run(norm, x, w, b, a, g)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    return {"device_kernels": sum(e.count for e in kernels) / reps,
            "device_us": sum(e.self_device_time_total for e in kernels) / reps}


def phase_kernel_norm_main(device) -> dict:
    """K1-K5 at the em_user shape (57,344 x 64), f32 and bf16 x: each
    against its plain version and timed beside its bound, the plain version
    and the library call; then one norm's forward + backward, fused and
    unfused, profiled. Returns kernel -> record (f32 numbers under the
    line's keys, bf16 under keys ending in _bf16)."""
    gen = torch.Generator().manual_seed(32)
    n, f = N_COMM * COMM_SIZE, EM_USER["hidden_dim"]
    records = {k: dict(name=f"graph_norm_{k}", route="cuda",
                       source="glass_tpu_torch/csrc/graph_norm.cu",
                       replaces=NORM_TPU[k].split()[0], tpu=[NORM_TPU[k]])
               for k in fn.KERNELS}
    per_norm = {}
    for dtype in X_DTYPES:
        sfx = "" if dtype == torch.float32 else "_bf16"
        x, dy, v = norm_case(gen, n, f, dtype, device)
        for k in fn.KERNELS:
            args = pass_args(k, x, dy, v)
            err, scale = check_pass(f"em_user {k} {dtype}", k, args)
            lib, lib_name = norm_library(k, dtype)
            lib_diff = None
            if lib is not None:
                ref = getattr(fn, f"{k}_reference")(*args)
                lib_diff = float((lib(*args).float() - ref.float()).abs().max())
            rec = records[k]
            run = getattr(fn, k)
            plain = getattr(fn, f"{k}_reference")
            rec[f"max_abs_err{sfx}"] = err
            rec[f"ms{sfx}"], parts = device_ms(lambda: run(*args))
            rec[f"plain_ms{sfx}"], _ = device_ms(lambda: plain(*args))
            rec[f"library_ms{sfx}"] = (None if lib is None else
                                       device_ms(lambda: lib(*args))[0])
            rec[f"library{sfx}"] = lib_name
            rec[f"bound_ms{sfx}"], rec[f"bound_by{sfx}"] = norm_bound_ms(k, x)
            rec[f"event_ms{sfx}"] = time_ms(lambda: run(*args))
            emit("kernel_norm_main", kernel=k, x=str(dtype), N=n, F=f,
                 max_abs_err=err, max_abs_ref=scale,
                 library_max_abs_diff=lib_diff, device_us_by_kernel=parts,
                 event_ms_with_host_gaps=rec[f"event_ms{sfx}"],
                 plain_event_ms=time_ms(lambda: plain(*args)),
                 **{key: rec[key + sfx] for key in (
                     "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        w, b = (torch.randn(f, generator=gen).to(device) for _ in range(2))
        a = (torch.randn(f, generator=gen) * 0.3 + 1).to(device)
        g = torch.randn(n, f, generator=gen).to(device)
        per_norm[str(dtype)] = {
            "fused": profile_norm(fn.fused_graph_norm, x, w, b, a, g),
            "unfused": profile_norm(graph_norm, x, w, b, a, g)}
        del x, dy
    emit("norm_fwd_bwd_profile", N=n, F=f, per_norm=per_norm)
    return records


# ------------------------------------------------ the experiment CLI path

CLI_SUBGRAPHS = {"train": 240, "val": 60, "test": 60}
CLI_EPOCHS, CLI_AB_EPOCHS, CLI_Q_EPOCHS, CLI_AUTO_EPOCHS = 15, 15, 12, 12
# fused vs unfused epoch losses, same dropout stream: float order only
# (tests/test_torch_protocol.py's protocol-loss tolerance)
CLI_LOSS_RTOL = 1e-4
CLI_AB_COMPARED_EPOCHS = 3
ITER_LINE = re.compile(r"iter (\d+) loss (\S+) val (\S+) tst (\S+)$")


def write_edge_list(path: Path, ei: np.ndarray) -> None:
    """``ei`` as SubGNN ``edge_list.txt`` lines ("row col", right-aligned
    in fixed-width columns), written from one byte array."""
    width = len(str(int(ei.max())))

    def digits(v):
        out = np.full((v.size, width), ord(" "), np.uint8)
        rest = v.astype(np.int64)
        for j in range(width - 1, -1, -1):
            out[:, j] = np.where((rest > 0) | (j == width - 1),
                                 ord("0") + rest % 10, ord(" "))
            rest = rest // 10
        return out

    e = ei.shape[1]
    lines = np.concatenate([digits(ei[0]), np.full((e, 1), ord(" "), np.uint8),
                            digits(ei[1]), np.full((e, 1), ord("\n"), np.uint8)],
                           axis=1)
    path.write_bytes(lines.tobytes())


def write_em_user_standin(root: Path) -> dict:
    """A SubGNN-format em_user at em_user's scale under ``root``: the
    clustered_graph edges (both directions, 9M lines) and size-labelled
    subgraphs split 240/60/60."""
    t0 = time.perf_counter()
    ei, n = clustered_graph()
    count = sum(CLI_SUBGRAPHS.values())
    pos, y = size_labelled_subgraphs(np.random.default_rng(41), count,
                                     N_COMM, COMM_SIZE)
    tags = [t for t, k in CLI_SUBGRAPHS.items() for _ in range(k)]
    d = root / "dataset" / "em_user"
    d.mkdir(parents=True)
    (d / "subgraphs.pth").write_text("".join(
        f"{'-'.join(map(str, row[row >= 0]))}\t{int(label)}\t{tag}\n"
        for row, label, tag in zip(pos, y, tags)))
    write_edge_list(d / "edge_list.txt", ei)
    return dict(n_node=n, directed_edges=ei.shape[1], subgraphs=count,
                edge_list_bytes=(d / "edge_list.txt").stat().st_size,
                write_s=time.perf_counter() - t0)


def counts_delta(before: dict, after: dict) -> dict:
    """after - before of launch_counts()-style dicts, zeros dropped."""
    out = {}
    for key, a in after.items():
        b = before[key]
        if isinstance(a, dict):
            out[key] = {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}
        else:
            out[key] = a - b
    return out


class EpochProbe:
    """Wraps Trainer.train_epoch while a CLI run lasts: per epoch its steps,
    mean loss, host ms, the CUDA-event span of its stream work, and the
    launch counts it made; and the trainer the run built."""

    def __init__(self):
        self.epochs, self.trainer = [], None
        self.t0 = time.perf_counter()

    def __enter__(self):
        real = Trainer.train_epoch
        self._real = real

        def train_epoch(trainer, pos_b, y_b):
            self.trainer = trainer
            before = dict(launch_counts(), norm_dtype=dict(
                fn.fused_graph_norm.launches_by_dtype),
                norm_launches=fn.fused_graph_norm.launches)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            res = real(trainer, pos_b, y_b)
            end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            after = dict(launch_counts(), norm_dtype=dict(
                fn.fused_graph_norm.launches_by_dtype),
                norm_launches=fn.fused_graph_norm.launches)
            self.epochs.append(dict(
                started_s=t0 - self.t0,
                steps=len(res.step_losses), loss=res.loss, host_ms=host_ms,
                event_ms=start.elapsed_time(end),
                counts=counts_delta(before, after)))
            return res

        Trainer.train_epoch = train_epoch
        return self

    def __exit__(self, *exc):
        Trainer.train_epoch = self._real


def run_cli(argv: list) -> tuple:
    """glass_tpu_torch.cli.glass_test.main(argv) in this process: (log
    lines, EpochProbe, mean, err, seconds, the run's launch counts)."""
    from glass_tpu_torch.cli import glass_test

    out = io.StringIO()
    reset_counts()  # the path starts here
    t0 = time.perf_counter()
    with EpochProbe() as probe, contextlib.redirect_stdout(out):
        mean, err = glass_test.main(argv)
    seconds = time.perf_counter() - t0
    counts = dict(launch_counts(), norm_dtype=dict(
        fn.fused_graph_norm.launches_by_dtype),
        norm_launches=fn.fused_graph_norm.launches)  # ... and ends here
    return (out.getvalue().splitlines(), probe, mean, err, seconds, counts)


def check_cli_log(lines: list, repeats: int, what: str) -> list:
    """Each repeat logged iter/val/tst lines; the average is finite.
    Returns the throughput lines."""
    sections, current = [], None
    for line in lines:
        if line.startswith("repeat "):
            current = []
            sections.append(current)
        elif current is not None:
            current.append(line)
    check(len(sections) == repeats, f"{what}: {len(sections)} repeats logged")
    for i, sec in enumerate(sections):
        check(any(ITER_LINE.match(l) for l in sec),
              f"{what}: repeat {i} logged no iter/val/tst line")
    avg = [l for l in lines if l.startswith("average ")]
    check(len(avg) == 1 and all(math.isfinite(float(t)) for t in
                                avg[0].split()[1::2]),
          f"{what}: average line {avg}")
    return [l for l in lines if l.startswith("throughput:")]


def model_counts(model) -> tuple:
    """(GraphNorm modules, conv layers) of a GLASS model."""
    from glass_tpu_torch.nn.modules import GLASSConv, GraphNorm

    mods = list(model.modules())
    return (sum(isinstance(m, GraphNorm) for m in mods),
            sum(isinstance(m, GLASSConv) for m in mods))


def check_epoch_launches(probe: EpochProbe, band_dtype: str, norm_dtype,
                         what: str) -> tuple:
    """Every training epoch launched, per step, 2 band kernels per conv
    layer (of ``band_dtype`` slabs) and, with the fused norm (``norm_dtype``
    not None), each of K1-K5 once per GraphNorm of the model, with
    LAUNCHES_PER_PASS CUDA launches each; and nothing else. Returns
    (launches per step by kernel, training steps, norms, conv layers)."""
    norms, convs = model_counts(probe.trainer.model)
    steps = 0
    for i, ep in enumerate(probe.epochs):
        s = ep["steps"]
        steps += s
        want_norm = ({} if norm_dtype is None else
                     {k: norms * s for k in fn.KERNELS})
        want = {"bcsr": {}, "band": {band_dtype: 2 * convs * s},
                "dense_q": 0, "norm": want_norm,
                "norm_dtype": ({} if norm_dtype is None else
                               {norm_dtype: len(fn.KERNELS) * norms * s}),
                "norm_launches": norms * s * sum(
                    fn.LAUNCHES_PER_PASS.values()) if norm_dtype else 0}
        check(ep["counts"] == want,
              f"{what} epoch {i}: launches {ep['counts']}, expected {want}")
    per_step = {"band": 2 * convs,
                "norm_passes": 0 if norm_dtype is None else
                len(fn.KERNELS) * norms,
                "norm_cuda_launches": 0 if norm_dtype is None else
                norms * sum(fn.LAUNCHES_PER_PASS.values())}
    return per_step, steps, norms, convs


def epoch_stats(probe: EpochProbe) -> dict:
    """Median host and CUDA-event ms per step over the epochs after the
    first (which carries the first launches' costs); the seconds before
    the first epoch (loading, layout build, model) and in the epochs."""
    eps = probe.epochs[1:] or probe.epochs
    return {"host_ms_per_step": statistics.median(
                e["host_ms"] / e["steps"] for e in eps),
            "event_ms_per_step": statistics.median(
                e["event_ms"] / e["steps"] for e in eps),
            "epochs": len(probe.epochs),
            "setup_s": probe.epochs[0]["started_s"],
            "epochs_s": sum(e["host_ms"] for e in probe.epochs) / 1e3}


def phase_cli_em_user(device, norm_records: dict) -> None:
    """The experiment CLI end to end at em_user on a SubGNN stand-in:
    two repeats with the fused norm, its launches per step, its best-val
    checkpoint served; the same command with the norm unfused, its losses
    and times beside the fused run's; and one repeat in int8 + bf16."""
    from glass_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  params_to_flax)

    with tempfile.TemporaryDirectory(prefix="glass_cli_") as tmp:
        tmp = Path(tmp)
        emit("cli_data", **write_em_user_standin(tmp / "data"))
        base_argv = ["--dataset", "em_user", "--use_deg", "--use_maxzeroone",
                     "--spmm", "pallas", "--sparse_layout", "band",
                     "--data_root", str(tmp / "data")]
        old_cache = os.environ.get("GLASS_CACHE_DIR")
        os.environ["GLASS_CACHE_DIR"] = str(tmp / "cache")
        try:
            with fused_norm(True):
                lines, probe, mean, err, secs, total = run_cli(
                    base_argv + ["--repeat", "2", "--max_epochs",
                                 str(CLI_EPOCHS), "--ckpt_dir",
                                 str(tmp / "ckpt")])
            throughput = check_cli_log(lines, 2, "cli_em_user")
            per_step, steps, norms, convs = check_epoch_launches(
                probe, "float32", "float32", "cli_em_user")
            train_norm = {k: norms * steps for k in fn.KERNELS}
            evals = {k: total["norm"].get(k, 0) - train_norm[k]
                     for k in fn.KERNELS}
            check(evals["bwd_reduce"] == evals["bwd_dx"] == 0
                  and evals["colsum"] == evals["varsum"] == evals["affine"]
                  and evals["colsum"] % norms == 0
                  and total["bcsr"] == {} and total["dense_q"] == 0,
                  f"cli_em_user: evaluation launches {total}")
            for k in fn.KERNELS:
                norm_records[k]["launches"] = total["norm"].get(k, 0)
                norm_records[k]["launches_per_step"] = norms
            fused = epoch_stats(probe)
            on_losses = [e["loss"] for e in probe.epochs[:CLI_EPOCHS]]
            emit("cli_em_user", repeats=2, epochs_per_repeat=CLI_EPOCHS,
                 training_steps=steps, graph_norms=norms, conv_layers=convs,
                 launches_per_step=per_step, run_launches=total,
                 eval_forward_norm_passes=evals["colsum"],
                 mean=mean, err=err, seconds=secs,
                 epoch_losses=[e["loss"] for e in probe.epochs],
                 iter_lines=[l for l in lines if ITER_LINE.match(l)],
                 end_lines=[l for l in lines if l.startswith("end:")],
                 throughput=throughput, **fused)

            ckpt = tmp / "ckpt" / "em_user_seed0_best.npz"
            check(ckpt.exists(), f"no best-val checkpoint at {ckpt}")
            trainer = probe.trainer
            served = em_user_model(int(trainer.x.max()), "pallas", device)
            pred = Predictor.from_checkpoint(served, trainer.graph, trainer.x,
                                             ckpt, device=device)
            saved = load_checkpoint(ckpt)
            check(all(np.array_equal(v, saved[k])
                      for k, v in params_to_flax(served).items()),
                  "the served model's parameters differ from the checkpoint")
            subs = make_request(np.random.default_rng(42),
                                EM_USER["batch_size"], N_COMM, COMM_SIZE)
            with fused_norm(True):
                logits = pred(subs)
            check(logits.shape == (len(subs), 1)
                  and np.isfinite(logits).all(),
                  f"checkpoint request logits {logits.shape}")
            emit("cli_checkpoint", path=ckpt.name, arrays=len(saved),
                 request_batch=len(subs),
                 max_abs_logit=float(np.abs(logits).max()))
            del pred, served, trainer, probe

            with fused_norm(False):
                lines_off, probe_off, mean_off, _, secs_off, total_off = \
                    run_cli(base_argv + ["--repeat", "1", "--max_epochs",
                                         str(CLI_AB_EPOCHS)])
            check_cli_log(lines_off, 1, "cli_em_user unfused")
            check_epoch_launches(probe_off, "float32", None,
                                 "cli_em_user unfused")
            check(total_off["norm"] == {}, "the unfused run launched norms")
            off_losses = [e["loss"] for e in probe_off.epochs]
            k = CLI_AB_COMPARED_EPOCHS
            check(np.allclose(off_losses[:k], on_losses[:k],
                              rtol=CLI_LOSS_RTOL, atol=0),
                  f"fused vs unfused epoch losses {on_losses[:k]} vs "
                  f"{off_losses[:k]}")
            unfused = epoch_stats(probe_off)
            emit("cli_em_user_unfused", repeats=1,
                 epochs_per_repeat=CLI_AB_EPOCHS, mean=mean_off,
                 seconds=secs_off,
                 epoch_losses=off_losses,
                 max_rel_loss_diff_first_epochs=float(np.max(
                     np.abs(np.subtract(off_losses[:k], on_losses[:k]))
                     / np.abs(on_losses[:k]))),
                 throughput=[l for l in lines_off
                             if l.startswith("throughput:")], **unfused)
            emit("cli_fused_norm_ab", fused=fused, unfused=unfused,
                 host_speedup=unfused["host_ms_per_step"]
                 / fused["host_ms_per_step"],
                 event_speedup=unfused["event_ms_per_step"]
                 / fused["event_ms_per_step"])
            del probe_off

            with fused_norm(True):
                lines_q, probe_q, mean_q, _, secs_q, total_q = run_cli(
                    base_argv + ["--repeat", "1", "--max_epochs",
                                 str(CLI_Q_EPOCHS), "--dense_dtype", "int8",
                                 "--compute_dtype", "bf16"])
            check_cli_log(lines_q, 1, "cli_em_user_q")
            per_step_q, steps_q, _, _ = check_epoch_launches(
                probe_q, "int8", "bfloat16", "cli_em_user_q")
            check(set(total_q["norm_dtype"]) == {"bfloat16"},
                  f"cli_em_user_q: norm passes by dtype {total_q['norm_dtype']}")
            emit("cli_em_user_q", adjacency="int8", compute="bfloat16",
                 training_steps=steps_q, launches_per_step=per_step_q,
                 run_launches=total_q, mean=mean_q, seconds=secs_q,
                 epoch_losses=[e["loss"] for e in probe_q.epochs],
                 iter_lines=[l for l in lines_q if ITER_LINE.match(l)],
                 **epoch_stats(probe_q))
            del probe_q
            cli_em_user_auto(tmp / "data")
        finally:
            if old_cache is None:
                os.environ.pop("GLASS_CACHE_DIR", None)
            else:
                os.environ["GLASS_CACHE_DIR"] = old_cache


def cli_em_user_auto(data_root: Path) -> None:
    """The experiment CLI at em_user with no --spmm and no --sparse_layout
    flag: the protocol routes the graph to "pallas" with RCM, the planner
    picks the layout; every epoch's launches per step are those of the
    planned layout (the norm unfused, the default)."""
    with fused_norm(False):
        lines, probe, mean, _, secs, total = run_cli(
            ["--dataset", "em_user", "--use_deg", "--use_maxzeroone",
             "--data_root", str(data_root), "--repeat", "1", "--max_epochs",
             str(CLI_AUTO_EPOCHS)])
    check_cli_log(lines, 1, "cli_em_user_auto")
    graph = probe.trainer.graph
    _, convs = model_counts(probe.trainer.model)
    check(graph.plan is not None and graph.plan == held_kind(graph),
          f"cli_em_user_auto: plan {graph.plan}, layout {held_kind(graph)}")
    modes = {m.spmm_mode for m in probe.trainer.model.modules()
             if hasattr(m, "spmm_mode")}
    check(modes == {"pallas"}, f"the protocol routed em_user to {modes}")
    x = torch.randn(graph.n_node, EM_USER["hidden_dim"],
                    generator=torch.Generator().manual_seed(43)).to(graph.device)
    errs = check_planned("cli_em_user_auto", graph, x)
    del x
    steps = 0
    for i, ep in enumerate(probe.epochs):
        want = dict(plan_launches(graph, 2 * convs * ep["steps"]),
                    norm_dtype={}, norm_launches=0)
        check(ep["counts"] == want,
              f"cli_em_user_auto epoch {i}: launches {ep['counts']}, "
              f"expected {want}")
        steps += ep["steps"]
    emit("cli_em_user_auto", repeats=1, training_steps=steps, **plan_summary(graph),
         max_abs_err=errs,
         launches_per_step=plan_launches(graph, 2 * convs), run_launches=total,
         mean=mean, seconds=secs,
         epoch_losses=[e["loss"] for e in probe.epochs],
         iter_lines=[l for l in lines if ITER_LINE.match(l)],
         average_line=[l for l in lines if l.startswith("average ")],
         **epoch_stats(probe))


def phase_train_norm_small(device) -> None:
    """3 steps with the fused norm on, card vs CPU, band and BCSR, at
    train_small's tolerances; the card's norm passes counted."""
    norms, _ = model_counts(GLASS(5, 16, 2, (1,), ("size",), device="cpu"))
    with fused_norm(True):
        for layout in ("band", "bcsr"):
            reset_counts()
            losses, params = small_training(device, layout)
            got = launch_counts()["norm"]
            losses_cpu, params_cpu = small_training(torch.device("cpu"), layout)
            want = {k: norms * len(losses) for k in fn.KERNELS}
            check(got == want, f"{layout}: norm passes {got}, expected {want}")
            loss_err = float(np.abs(losses - losses_cpu).max())
            param_err = max(float((params[k] - params_cpu[k]).abs().max())
                            for k in params)
            check(np.isfinite(losses).all(), f"{layout}: non-finite losses")
            check(np.allclose(losses, losses_cpu, rtol=TRAIN_LOSS_RTOL, atol=0),
                  f"{layout}: card losses {losses} vs CPU {losses_cpu}")
            check(param_err <= TRAIN_PARAM_ATOL_LRS * EM_USER["lr"],
                  f"{layout}: parameters differ by {param_err} after 3 steps")
            emit("train_norm_small", layout=layout, steps=len(losses),
                 graph_norms=norms, norm_passes=got, losses=losses.tolist(),
                 max_abs_loss_diff=loss_err, max_abs_param_diff=param_err)


# ------------------------------------------------------- HBM read probes

PROBE_TPU = {"read": "tools/hbm_probe.py:89 _read_kernel",
             "read2": "tools/hbm_probe.py:164 _read2_kernel"}
PROBE_SMALL_CHUNKS = (64, 1800, 2048)
PROBE_SMALL_STEPS = 4


def load_tool(name: str):
    """tools/<name>.py as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_probe(what: str, run, plain) -> None:
    """run(iters) at iters 3, 3 again and 1 against plain(): bit-equal,
    the repeat bit-identical."""
    out, again, one, ref = run(3), run(3), run(1), plain()
    torch.cuda.synchronize()
    check(torch.equal(out, ref) and torch.equal(one, ref),
          f"{what}: differs from the plain slice")
    check(torch.equal(out, again), f"{what}: repeat differs")


def phase_probe_small(device) -> None:
    """Both probe bodies against their plain versions, bit-equal, repeats
    bit-identical, at S 1-8 (read2: 2 and 4), chunk_rows 64, 1800 and 2048
    and iters 1 and 3, on data that differs in every row. The tilings
    cover a CTA that holds all 8 output rows, output rows spread over
    several CTAs, and a last CTA with fewer rows than the others."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator().manual_seed(51)
    tilings = set()
    for chunk in PROBE_SMALL_CHUNKS:
        rows = PROBE_SMALL_STEPS * chunk
        x = torch.randn(rows, hp.LANES, generator=gen).to(device)
        for s in (1, 2, 4, 8):
            if chunk % s or chunk // s < hp.OUT_ROWS:
                continue
            ctas, q, smem = hp.tiling(chunk // s, s, sms)
            tilings.add((q >= hp.OUT_ROWS, (chunk // s) % q != 0))
            check_probe(f"read S={s} chunk {chunk}",
                        lambda it: hp.hbm_read(x, chunk, s, it),
                        lambda: hp.hbm_read_reference(x, chunk, s, 1))
            emit("probe_small", probe="read", stripes=s, chunk_rows=chunk,
                 rows=rows, ctas=ctas, q=q, smem_bytes=smem, bit_equal=True)
            if s in (2, 4):
                xs = [torch.randn(rows // s, hp.LANES, generator=gen)
                      .to(device) for _ in range(s)]
                check_probe(f"read2 S={s} chunk {chunk}",
                            lambda it: hp.hbm_read2(xs, chunk, it),
                            lambda: hp.hbm_read2_reference(xs, chunk, 1))
                emit("probe_small", probe="read2", stripes=s,
                     chunk_rows=chunk, rows=rows, ctas=ctas, q=q,
                     bit_equal=True)
    check(any(t[0] for t in tilings) and any(not t[0] for t in tilings)
          and any(t[1] for t in tilings),
          f"the small probes lack a tiling case: {sorted(tilings)}")


PROBE_MB, PROBE_ITERS, PROBE_CHUNK_ROWS = 512, 40, 2048


def phase_probe_main(device) -> list:
    """tools/torch_hbm_probe.py's probes at 512 MiB: the copy probe, read at
    S 1-8 and read2 at S 2 and 4, each kernel first held bit-equal to its
    plain version at that shape. Returns the two kernels' records (ms and
    the bound per pass of 512 MiB, at S = 1 for read and S = 2 for read2;
    every S under by_stripes)."""
    tool = load_tool("torch_hbm_probe")
    rows = tool.probe_rows(PROBE_MB, PROBE_CHUNK_ROWS)
    gen = torch.Generator(device=device).manual_seed(52)
    x = torch.rand(rows, hp.LANES, generator=gen, device=device)
    n_steps = rows // PROBE_CHUNK_ROWS
    xs = list(x.view(2, rows // 2, hp.LANES))  # read2 at S = 2: two halves
    cases = {"read": (lambda v: hp.hbm_read(v, PROBE_CHUNK_ROWS, 1, 1),
                      lambda v: hp.hbm_read_reference(v, PROBE_CHUNK_ROWS, 1,
                                                      1), x),
             "read2": (lambda v: hp.hbm_read2(v, PROBE_CHUNK_ROWS, 1),
                       lambda v: hp.hbm_read2_reference(v, PROBE_CHUNK_ROWS,
                                                        1),
                       [t.contiguous() for t in xs])}
    records = {}
    for name, (run, plain, arg) in cases.items():
        out, ref = run(arg), plain(arg)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"{name} at {PROBE_MB} MiB differs from "
              "its plain version")
        records[name] = dict(
            name=f"hbm_{name}", route="cuda",
            source="glass_tpu_torch/csrc/hbm_probe.cu",
            replaces=PROBE_TPU[name].split()[0], tpu=[PROBE_TPU[name]],
            max_abs_err=0.0, plain_ms=time_ms(lambda: plain(arg)),
            library_ms=None,
            bound_ms=rows * hp.ROW_BYTES / PEAK_HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", chunk_rows=PROBE_CHUNK_ROWS, chunks=n_steps,
            mib=rows * hp.ROW_BYTES / 2**20)
    del xs, cases, x
    torch.cuda.empty_cache()
    hp.hbm_read.launches = hp.hbm_read2.launches = 0  # the path starts here
    results = tool.run(PROBE_MB, PROBE_ITERS, PROBE_CHUNK_ROWS,
                       ("copy", "read", "read2"))
    launches = {"read": hp.hbm_read.launches,
                "read2": hp.hbm_read2.launches}  # ... and ends here
    copy = next(r for r in results if r["probe"] == "copy")
    for name, rec in records.items():
        by_s = {r["stripes"]: r for r in results if r["probe"] == name}
        check(set(by_s) == set(tool.READ_STRIPES if name == "read"
                               else tool.READ2_STRIPES),
              f"{name}: stripes {sorted(by_s)}")
        check(launches[name] > 0, f"{name}: the probe path launched no kernel")
        main_s = min(by_s)
        rec.update(ms=by_s[main_s]["us_per_pass"] / 1e3, stripes=main_s,
                   launches=launches[name],
                   copy_probe_gb_per_s=copy["gb_per_s"],
                   by_stripes={s: dict(ms=r["us_per_pass"] / 1e3,
                                       gb_per_s=r["gb_per_s"],
                                       share_of_peak=r["share_of_peak"])
                               for s, r in by_s.items()})
        emit("probe_main", kernel=name, **{k: rec[k] for k in (
            "ms", "bound_ms", "plain_ms", "launches", "copy_probe_gb_per_s",
            "by_stripes")})
    return list(records.values())


# ------------------------------------------------- the layout planner

HYBRID_FAR_EDGES = 4000  # symmetric far edges, first to last community
HYBRID_STEPS = 20
HYBRID_MIN_BAND_SHARE = 0.5


def plan_launches(graph, n: int) -> dict:
    """The launch counts (launch_counts' form) of ``n`` SpMMs on the layout
    the graph holds: band and BCSR by their dtype (both for a hybrid), the
    int8 dense kernel, and no kernel for a dense f32/bf16 matrix
    (torch.matmul) or the segment path."""
    want = {"bcsr": {}, "band": {}, "dense_q": 0, "norm": {}}
    if graph.band is not None:
        want["band"] = {str(graph.band.slabs.dtype).removeprefix("torch."): n}
    if graph.bcsr is not None:
        want["bcsr"] = {str(graph.bcsr.blocks.dtype).removeprefix("torch."):
                        n}
    if graph.band is None and graph.bcsr is None and graph.dense_q is not None:
        want["dense_q"] = n
    return want


def held_kind(graph) -> str:
    """The layout the graph holds, in the planner's words."""
    if graph.band is not None:
        return "hybrid" if graph.bcsr is not None else "band"
    if graph.bcsr is not None:
        return "bcsr"
    return ("dense" if graph.dense is not None or graph.dense_q is not None
            else "segment")


def check_planned(what: str, graph, x) -> dict:
    """Holds each kernel of the layout a graph holds against its plain
    version on x (KERNEL_TOL): band, band_t, BCSR, BCSR_t, int8 dense;
    where the layout launches no kernel (a dense f32/bf16 matrix or the
    segment path), the "pallas" SpMM against the "segment" mode within rtol
    1e-4. Returns the max |kernel - plain| of each part."""
    errs = {}
    parts = [("band", graph.band, bd.band_spmm, bd.band_spmm_reference),
             ("bcsr", graph.bcsr, bs.bcsr_spmm, bs.bcsr_spmm_reference)]
    if graph.band_t is not graph.band:
        parts.append(("band_t", graph.band_t, bd.band_spmm,
                      bd.band_spmm_reference))
    if graph.bcsr_t is not graph.bcsr:
        parts.append(("bcsr_t", graph.bcsr_t, bs.bcsr_spmm,
                      bs.bcsr_spmm_reference))
    for part, layout, fn, plain in parts:
        if layout is not None:
            errs[part], _ = check_vs_plain(
                f"{what} {part}", lambda v, a=layout, f=fn: f(a, v),
                lambda v, a=layout, p=plain: p(a, v), x)
    if graph.band is None and graph.bcsr is None and graph.dense_q is not None:
        errs["dense_q"], _ = check_vs_plain(
            f"{what} dense_q", lambda v: dq.dense_q_spmm(graph.dense_q, None, v),
            lambda v: dq.dense_q_spmm_reference(graph.dense_q, v), x)
    if not errs:
        out, ref = spmm(graph, x, "pallas"), spmm(graph, x, "segment")
        scale = float(ref.abs().max())
        errs["vs_segment"] = float((out - ref).abs().max())
        check(torch.allclose(out, ref, rtol=1e-4, atol=1e-5 * scale),
              f"{what}: {graph.plan} vs segment max|diff| "
              f"{errs['vs_segment']}")
    return errs


def plan_summary(graph) -> dict:
    """The planner's choice as the graph holds it."""
    out = dict(plan=graph.plan, kind=held_kind(graph))
    if graph.band is not None:
        out.update(rps=graph.band.rps, w_blocks=graph.band.w_blocks,
                   affine_stride=graph.band.affine_stride,
                   affine_off=graph.band.affine_off,
                   slab_dtype=str(graph.band.slabs.dtype),
                   slab_bytes=graph.band.slabs.numel()
                   * graph.band.slabs.element_size())
    if graph.bcsr is not None:
        out.update(bcsr_stored_blocks=graph.bcsr.blocks.shape[0] * bs.CHUNK,
                   bcsr_dtype=str(graph.bcsr.blocks.dtype))
    return out


def planner_costs(ei, n, aggr, dense_dtype) -> dict:
    """The planner's modeled seconds per family on this graph (the same
    call build_graph makes)."""
    from glass_tpu_torch.ops import graph as tg
    from glass_tpu_torch.ops.bcsr_spmm import coo_is_symmetric

    w = tg.normalized_edge_weight(ei, np.ones(ei.shape[1]), n, aggr)
    row, col = ei[0].astype(np.int64), ei[1].astype(np.int64)
    order = np.lexsort((col, row))
    row, col, w = row[order], col[order], w[order]
    sym = coo_is_symmetric(row, col, (w != 0).astype(np.float32))
    kind, rps, wb, costs = tg._plan_block_sparse(
        row, col, w, n, dense_dtype, None, "auto", sym, with_costs=True)
    other = tg._dense_segment_costs(n, ei.shape[1], dense_dtype)
    costs.update(dense=other["dense"], segment=other["segment"])
    return dict(block_sparse=[kind, rps, wb], **{f"{k}_ms": v * 1e3
                                                for k, v in costs.items()})


def phase_autotune(device) -> dict:
    """ensure_autotune on the card into a temporary file (the CLI's
    --autotune), its three constants printed; then the em_user stand-in
    planned under that file. Returns the fitted constants."""
    from glass_tpu_torch.ops.autotune import ensure_autotune

    old = os.environ.get("GLASS_TPU_AUTOTUNE")
    with tempfile.TemporaryDirectory(prefix="glass_autotune_") as tmp:
        path = Path(tmp) / "autotune_cuda.json"
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                ensure_autotune(str(path), device=device)
            fitted = json.loads(path.read_text())
            check(os.environ["GLASS_TPU_AUTOTUNE"] == str(path),
                  "ensure_autotune did not export its file")
            check(all(fitted[k] > 0 for k in (
                "band_step_cost_s", "bcsr_step_cost_s", "stream_bps")),
                f"fitted constants {fitted}")
            ei, n = clustered_graph()
            costs = planner_costs(ei, n, EM_USER["aggr"], "f32")
        finally:
            if old is None:
                os.environ.pop("GLASS_TPU_AUTOTUNE", None)
            else:
                os.environ["GLASS_TPU_AUTOTUNE"] = old
    emit("autotune", seconds=time.perf_counter() - t0, fitted=fitted,
         em_user_plan_under_fit=costs)
    return fitted


FILL_ROW_BLOCKS = (32, 64, 96)  # fewer row blocks than fill the card
FILL_FULL_ROW_BLOCKS = 448      # em_user's: a full card
FILL_WIDTH = 8                  # window blocks of the fill layouts


def phase_planner_rates(device) -> dict:
    """The planner's rates that the calibration does not fit, on this card
    (ops/graph.py's _MXU_FLOPS, _DENSE_Q_FLOPS, _GATHER_BPS and
    _CARD_ROW_BLOCKS):
    - the dense candidate: torch.matmul of an (n, n) matrix with (n, 128)
      x at the hpo shape, f32 (TF32 off) and bf16, and the int8 dense
      kernel on an (n, n) int8 layout, as 2 n^2 128 / time;
    - the segment candidate: the "segment" SpMM at the em_user shape, H =
      128, as the model counts its bytes, 2 (16 + 128 * 4) per edge;
    - the card's fill: the f32 band kernel (H = 64) on banded layouts of R
      row blocks, one launch at a time (time_ms, as the model's paths
      launch it) against a busy card (ops/autotune.py's CUDA graph over 8
      streams). Below the card's fill, busy / alone = R / row blocks of a
      full card, so each R gives R * alone / busy; the median is the
      estimate. At em_user's 448 row blocks alone / busy should be ~1."""
    from glass_tpu_torch.ops import autotune as at
    from glass_tpu_torch.ops.spmm import spmm_segment

    gen = torch.Generator().manual_seed(60)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    rates = {}
    n = HPO_NODES
    a = torch.randn(n, n, generator=gen).to(device)
    x = torch.randn(n, 128, generator=gen).to(device)
    for key, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        aa, xx = a.to(dt), x.to(dt)
        ms = time_ms(lambda: torch.matmul(aa, xx))
        rates[f"mxu_flops_{key}"] = 2.0 * n * n * 128 / (ms / 1e3)
        rates[f"matmul_ms_{key}"] = ms
    del a, aa, xx
    pad = -(-n // BLOCK) * BLOCK  # the kernel's time does not hang on values
    q = torch.zeros(pad, pad, dtype=torch.int8, device=device)
    q[:n, :n] = torch.randint(-127, 128, (n, n), generator=gen,
                              dtype=torch.int8).to(device)
    layout = dq.DenseQ(q=q, scale=torch.rand(pad, generator=gen).to(device),
                       n_row=n, n_col=n)
    ms = time_ms(lambda: dq.dense_q_spmm(layout, None, x))
    rates["dense_q_flops"] = 2.0 * n * n * 128 / (ms / 1e3)
    rates["dense_q_ms"] = ms
    del q, layout, x
    ei, n = clustered_graph()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_dense=False,
                        device=device)
    x = torch.randn(n, 128, generator=gen).to(device)
    ms = time_ms(lambda: spmm_segment(graph, x))
    rates["gather_bps"] = graph.n_edge * 2 * (16 + 128 * 4) / (ms / 1e3)
    rates["segment_ms"] = ms
    del graph, x

    rng = np.random.default_rng(61)
    fill = {}
    for r_blocks in FILL_ROW_BLOCKS + (FILL_FULL_ROW_BLOCKS,):
        r, c, n = at._banded_graph(r_blocks, FILL_WIDTH, 4000, rng)
        band = bd.build_band(r, c, np.ones(r.size, np.float32), n, 1,
                             device=device)
        x = torch.randn(n, EM_USER["hidden_dim"], generator=gen).to(device)
        alone = time_ms(lambda: bd.band_spmm(band, x))
        busy = at.cuda_graph_seconds(lambda v: bd.band_spmm(band, v), x,
                                     100) * 1e3
        fill[r_blocks] = dict(alone_ms=alone, busy_ms=busy,
                              alone_over_busy=alone / busy,
                              full_row_blocks=r_blocks * alone / busy,
                              slab_bytes=band.slabs.numel() * 4)
        del band, x
    rates["card_row_blocks"] = statistics.median(
        fill[r]["full_row_blocks"] for r in FILL_ROW_BLOCKS)
    emit("planner_rates", hpo_n=HPO_NODES, **rates, fill_by_row_blocks=fill,
         sms=torch.cuda.get_device_properties(device).multi_processor_count)
    return rates


def train_one_epoch(graph, feats, model, cfg, pos, y, rng, steps=None):
    """One Trainer epoch (at most ``steps`` steps), its launch counts read
    around it. Returns (losses, steps, counts, ms per step)."""
    trainer = Trainer(model, graph, feats, cfg)
    trainer.init(0)
    pos_b, y_b = make_train_batches(rng, pos, y, cfg.batch_size)
    if steps is not None:
        pos_b, y_b = pos_b[:steps], y_b[:steps]
    reset_counts()  # the path starts here
    t0 = time.perf_counter()
    res = trainer.train_epoch(pos_b, y_b)
    ms = (time.perf_counter() - t0) * 1e3 / len(res.step_losses)
    counts = launch_counts()  # ... and ends here
    return res.step_losses, len(res.step_losses), counts, ms


def alternative_ms(ei, n, aggr, dense_dtype, graph, costs, x, device,
                   kind=None) -> dict:
    """The card's time of the layout the planner ranked next on this graph:
    the best block-sparse layout when it chose the dense path, else the
    dense path; or the block-sparse layout ``kind`` (its kernels held
    against their plain versions too)."""
    if kind is None and graph.plan == "dense":
        kind = costs["block_sparse"][0]
    if kind is not None:
        alt = build_graph(ei, None, n, aggr, materialize_dense=False,
                          materialize_bcsr=True, sparse_layout=kind,
                          dense_dtype=dense_dtype, device=device)
        errs = check_planned(f"{kind} beside the {graph.plan} plan", alt, x)
        mode = "pallas"
    else:
        kind, errs, mode = "dense", {}, "dense"
        alt = build_graph(ei, None, n, aggr, materialize_dense=True,
                          dense_dtype=dense_dtype, device=device)

    def run():
        return spmm(alt, x, mode)

    out = dict(plan_summary(alt) if kind != "dense" else {"kind": kind},
               spmm_ms=time_ms(run), spmm_device_ms=cold_ms(run),
               max_abs_err=errs)
    del alt
    return out


def phase_planner_main(device) -> None:
    """The planner on the em_user and hpo stand-ins, f32 and int8, as the
    protocol's "pallas" route builds them (materialize_dense=False,
    sparse_layout="auto"): the choice (kind, rps, window, modeled costs),
    each kernel of the chosen layout against its plain version, and the
    card's time of one "pallas" SpMM on it at H = 64; on hpo one training
    epoch, its launches those of the chosen layout, and the time of the
    layout ranked next."""
    for dd in ("f32", "int8"):
        ei, n = clustered_graph()
        t0 = time.perf_counter()
        graph = build_graph(ei, None, n, EM_USER["aggr"],
                            materialize_dense=False, materialize_bcsr=True,
                            sparse_layout="auto", dense_dtype=dd,
                            device=device)
        sync(device)
        build_s = time.perf_counter() - t0
        check(graph.plan == held_kind(graph),
              f"em_user {dd}: plan {graph.plan}, layout {held_kind(graph)}")
        x = torch.randn(n, EM_USER["hidden_dim"],
                        generator=torch.Generator().manual_seed(28)).to(device)
        errs = check_planned(f"em_user {dd} planned", graph, x)
        spmm_ms = time_ms(lambda: spmm(graph, x, "pallas"))
        costs = planner_costs(ei, n, EM_USER["aggr"], dd)
        # the other block-sparse family, timed the same way
        other = "band" if graph.plan == "bcsr" else "bcsr"
        emit("planner_main", graph="em_user", dense_dtype=dd, n_node=n,
             build_s=build_s, **plan_summary(graph), max_abs_err=errs,
             spmm_ms=spmm_ms, spmm_device_ms=cold_ms(
                 lambda: spmm(graph, x, "pallas")), costs=costs,
             next_ranked=alternative_ms(ei, n, EM_USER["aggr"], dd, graph,
                                        costs, x, device, kind=other))
        del graph

        ei, n = hpo_graph()
        t0 = time.perf_counter()
        graph = build_graph(ei, None, n, HPO_METAB["aggr"],
                            materialize_dense=False, materialize_bcsr=True,
                            sparse_layout="auto", dense_dtype=dd,
                            device=device)
        sync(device)
        build_s = time.perf_counter() - t0
        check(graph.plan == held_kind(graph),
              f"hpo {dd}: plan {graph.plan}, layout {held_kind(graph)}")
        feats_np = degree_features(ei, n)
        model = GLASS(int(feats_np.max()), HPO_METAB["hidden_dim"],
                      HPO_METAB["conv_layer"], (HPO_CLASSES,),
                      (HPO_METAB["pool"],), activation=HPO_METAB["activation"],
                      z_ratio=HPO_METAB["z_ratio"], jk=HPO_METAB["jk"],
                      dropout=HPO_METAB["dropout"], spmm_mode="pallas",
                      seed=0, device=device)
        rng = np.random.default_rng(27)
        pos, y = class_labelled_subgraphs(rng, HPO_SUBGRAPHS, n, HPO_CLASSES)
        losses, steps, counts, ms = train_one_epoch(
            graph, torch.from_numpy(feats_np).to(device), model,
            TrainConfig(lr=HPO_METAB["lr"], resi=HPO_METAB["resi"],
                        batch_size=HPO_METAB["batch_size"], loss="ce"),
            pos, y, rng)
        want = plan_launches(graph, 2 * HPO_METAB["conv_layer"] * steps)
        check(counts == want, f"hpo {dd} ({graph.plan}): launches {counts}, "
              f"expected {want}")
        check(np.isfinite(losses).all(), f"hpo {dd}: non-finite losses")
        x = torch.randn(n, HPO_METAB["hidden_dim"],
                        generator=torch.Generator().manual_seed(28)).to(device)
        errs = check_planned(f"hpo {dd} planned", graph, x)
        spmm_ms = time_ms(lambda: spmm(graph, x, "pallas"))
        spmm_device_ms = cold_ms(lambda: spmm(graph, x, "pallas"))
        costs = planner_costs(ei, n, HPO_METAB["aggr"], dd)
        del model
        emit("planner_main", graph="hpo", dense_dtype=dd, n_node=n,
             build_s=build_s, **plan_summary(graph), max_abs_err=errs,
             spmm_ms=spmm_ms, spmm_device_ms=spmm_device_ms, costs=costs,
             train_steps=steps,
             launches=counts, ms_per_step=ms,
             losses=list(map(float, losses)),
             next_ranked=alternative_ms(ei, n, HPO_METAB["aggr"], dd, graph,
                                        costs, x, device))
        del graph


def hybrid_edges():
    """The em_user stand-in plus HYBRID_FAR_EDGES symmetric edges between
    the first and the last community (tests/test_pallas_band.py:179-186 at
    full size): a narrow band with a far residue."""
    ei, n = clustered_graph()
    rng = np.random.default_rng(53)
    src = rng.integers(0, COMM_SIZE, HYBRID_FAR_EDGES)
    dst = (N_COMM - 1) * COMM_SIZE + rng.integers(0, COMM_SIZE,
                                                  HYBRID_FAR_EDGES)
    far = np.stack([np.r_[src, dst], np.r_[dst, src]])
    return np.concatenate([ei, far], axis=1), n


def band_csr(band) -> torch.Tensor:
    """A band layout as a torch CSR tensor (the library yardstick's input
    for the band part alone; timed only)."""
    g, r, k = torch.nonzero(band.slabs, as_tuple=True)
    rows = g * band.rps * BLOCK + r
    cols = band.clo.long()[g] * BLOCK + k
    n = band.n_node
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.stack([rows, cols]), band.slabs[g, r, k].float(), (n, n),
        ).coalesce().to_sparse_csr()


def phase_hybrid_main(device) -> dict:
    """The hybrid split at em_user width: the band (per-group windows) and
    the BCSR residue, each kernel against its plain version; a training
    epoch with 2 band and 2 BCSR launches per step; requests against the
    "segment" mode within rtol 1e-4. Returns the per-group band kernel's
    record (row 5 of the TPU kernel table at full width)."""
    gen = torch.Generator().manual_seed(54)
    ei, n = hybrid_edges()
    t0 = time.perf_counter()
    graph = build_graph(ei, None, n, EM_USER["aggr"], materialize_bcsr=True,
                        sparse_layout="hybrid", device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    band, bcsr = graph.band, graph.bcsr
    check(band is not None and bcsr is not None and graph.band_t is band
          and graph.bcsr_t is bcsr and band.affine_stride is None,
          "the hybrid graph lacks its symmetric band and BCSR parts")
    band_nnz = int((band.slabs != 0).sum())
    bcsr_nnz = int((bcsr.blocks != 0).sum())
    share = band_nnz / (band_nnz + bcsr_nnz)
    check(share > HYBRID_MIN_BAND_SHARE,
          f"the band carries {share:.3f} of the nonzeros")
    emit("graph_hybrid", n_node=n, directed_edges=graph.n_edge,
         far_edges=2 * HYBRID_FAR_EDGES, build_s=build_s,
         band_nonzeros=band_nnz, bcsr_nonzeros=bcsr_nnz, band_share=share,
         **plan_summary(graph))

    h = EM_USER["hidden_dim"]
    x = torch.randn(n, h, generator=gen).to(device)
    err, scale = check_vs_plain("hybrid band", lambda v: bd.band_spmm(band, v),
                                lambda v: bd.band_spmm_reference(band, v), x)
    b_err, _ = check_vs_plain("hybrid bcsr", lambda v: bs.bcsr_spmm(bcsr, v),
                              lambda v: bs.bcsr_spmm_reference(bcsr, v), x)
    adj = band_csr(band)
    record = kernel_record(
        "band_spmm_per_group", "glass_tpu_torch/csrc/band_spmm.cu",
        "glass_tpu/ops/pallas_band.py:465", BAND_TPU[1:],
        lambda v: bd.band_spmm(band, v),
        lambda v: bd.band_spmm_reference(band, v),
        lambda v: torch.sparse.mm(adj, v), x, band_bound_ms(band, x), err)
    emit("kernel_band_per_group_main", H=h, max_abs_err=err,
         max_abs_ref=scale, bcsr_max_abs_err=b_err,
         **{k: record[k] for k in TIME_KEYS})
    del adj, x

    feats_np = degree_features(ei, n)
    feats = torch.from_numpy(feats_np).to(device)
    model = em_user_model(int(feats_np.max()), "pallas", device,
                          dropout=EM_USER["dropout"])
    rng = np.random.default_rng(55)
    pos, y = size_labelled_subgraphs(rng, TRAIN_SUBGRAPHS, N_COMM, COMM_SIZE)
    losses, steps, counts, ms = train_one_epoch(
        graph, feats, model, TrainConfig(
            lr=EM_USER["lr"], resi=EM_USER["resi"],
            batch_size=EM_USER["batch_size"], loss="bce"),
        pos, y, rng, steps=HYBRID_STEPS)
    per = 2 * EM_USER["conv_layer"] * steps
    check(counts == {"bcsr": {"float32": per}, "band": {"float32": per},
                     "dense_q": 0, "norm": {}},
          f"hybrid training launches {counts}: expected {per} band and {per} "
          "BCSR launches")
    check(np.isfinite(losses).all(), "hybrid: non-finite losses")
    record["launches"] = counts["band"].get("float32", 0)
    record["launches_per_step"] = 2 * EM_USER["conv_layer"]
    emit("train_hybrid", steps=steps, launches=counts, ms_per_step=ms,
         losses=list(map(float, losses)))

    pred = Predictor(model, graph, feats, device=device)
    model_seg = em_user_model(int(feats_np.max()), "segment", device)
    model_seg.load_state_dict(model.state_dict())
    pred_seg = Predictor(model_seg, graph, feats, device=device)
    requests = [make_request(np.random.default_rng(56), b, N_COMM, COMM_SIZE)
                for b in REQUEST_BATCHES]
    served, _ = serve_requests(pred, requests,
                               {"band": "float32", "bcsr": "float32"},
                               EM_USER["conv_layer"])
    for subs, out, ms in served:
        ref = pred_seg(subs)
        diff = float(np.abs(out - ref).max())
        ref_scale = float(np.abs(ref).max())
        check(np.allclose(out, ref, rtol=1e-4, atol=1e-5 * ref_scale),
              f"hybrid batch {len(subs)}: vs segment max|diff| {diff}")
        emit("request_hybrid", batch=len(subs), ms_first=ms,
             max_abs_diff_vs_segment=diff, max_abs_logit=ref_scale)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    paths = _build.build()
    notes = [line.strip() for p in paths.values()
             for line in p.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in paths.values()], ptxas=notes)

    phase_probe_small(device)
    records = phase_probe_main(device)
    with fused_norm(False):  # the unfused GraphNorm on the earlier paths
        phase_small(device)
        records.append(phase_main(device))
        phase_train_bcsr(device, records[-1])
        phase_band_small(device)
        phase_grad_small(device)
        phase_train_small(device)
        band_record, f32_score = phase_band_main(device)
        records.append(band_record)
        phase_kernel_q_small(device)
        phase_grad_q_small(device)
        phase_train_q_small(device)
        records.append(phase_band_q_main(device, f32_score))
        records.extend(phase_q_layouts_main(device))
        records.append(phase_dense_q_main(device))
        phase_planner_rates(device)
        phase_autotune(device)
        phase_planner_main(device)
        records.append(phase_hybrid_main(device))
    phase_kernel_norm_small(device)
    norm_records = phase_kernel_norm_main(device)
    phase_train_norm_small(device)
    phase_cli_em_user(device, norm_records)
    records.extend(norm_records.values())

    for record in records:
        record["us"] = record["ms"] * 1e3
        record["library_us"] = (None if record["library_ms"] is None
                                else record["library_ms"] * 1e3)
        record["max_abs_diff"] = record["max_abs_err"]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

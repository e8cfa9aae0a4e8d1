#!/usr/bin/env python3
"""Drives the PyTorch/H100 port of GLASS, serving and training, on one CUDA
card and checks it.

Run from the root of the repository, on a machine with one card:

    python3 chip_smoke.py

Phases, one printed line each:
  1. device  — no CUDA means a non-zero exit; prints the card's name and
               power limit as nvidia-smi gives them.
  2. build   — compiles every CUDA source of glass_tpu_torch/csrc with nvcc
               (one process per source, all started together).
  3. kernel vs plain, small layout — the BCSR kernel against its plain
               PyTorch version on a layout with empty row blocks and a row of
               more than 8 nonzero blocks, at H = 17 and 128; and a small
               GLASS on the card against the same model on the CPU.
  4. main path at the em_user configuration (glass_tpu/configs/em_user.yml)
     on a 57,344-node, 9M-edge stand-in graph (the recipe of
     bench.py::clustered_graph): the graph build; the kernel against its
     plain version, timed beside torch.sparse.mm; then requests of 1, 6 and
     64 subgraphs served through Predictor, each sent twice, with the
     kernel's launch count read around them, the repeat checked
     bit-identical and the logits checked against the independent "segment"
     SpMM mode.
  5. the band kernel and the backward passes on small layouts:
     kernel_band_small — the band kernel against its plain version at
               H = 17, 64 and 128 on an affine layout (negative offset,
               bottom overhang), a per-group layout (the affine gate
               rejects a piecewise profile) and a layout with empty groups
               and n % 128 != 0, each call repeated bit-identically;
     grad_small — on an asymmetric ("mean") graph, dx through each kernel's
               autograd Function against dx through its plain version's
               autograd, band and BCSR;
     train_small — a small GLASS trained 3 steps on the card and on the CPU
               with dropout 0, band and BCSR, losses and parameters compared.
  6. the training path at the em_user configuration on the same stand-in
     graph, banded-slab layout: graph_band (the build), kernel_band_main
     (the kernel against its plain version, timed beside torch.sparse.mm
     and its bound), train (Trainer epochs with em_user's dropout, batch and
     lr on synthetic subgraphs labelled by size, the band kernel's launches
     read around them: 2 per conv layer and step), request_band (requests
     served on the band graph, checked as in 4).
Then the card line again, one {"kernels": [...]} JSON line and, last,
{"ok": true, "device": {...}}. Any failure exits non-zero without that line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from glass_tpu_torch import (GLASS, Predictor, TrainConfig, Trainer,
                             build_graph, make_eval_batches,
                             make_train_batches)
from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import band_spmm as bd
from glass_tpu_torch.ops import bcsr_spmm as bs
from glass_tpu_torch.ops._common import BLOCK
from glass_tpu_torch.ops.graph import degrees
from glass_tpu_torch.train.metrics import pad_eval_labels

# glass_tpu/configs/em_user.yml; activation "elu" as the experiment protocol
# builds GLASS (glass_tpu/train/protocol.py::make_glass_model).
EM_USER = dict(hidden_dim=64, conv_layer=1, pool="size", z_ratio=0.75, jk=True,
               aggr="gcn", batch_size=6, activation="elu", dropout=0.5,
               lr=1e-3, resi=0.7)
N_COMM, COMM_SIZE, UNDIRECTED_EDGES = 448, 128, 4_500_000
REQUEST_BATCHES = (1, EM_USER["batch_size"], 64)
# the training phase: synthetic subgraphs (train + eval) and epochs
TRAIN_SUBGRAPHS, EVAL_SUBGRAPHS, TRAIN_EPOCHS = 240, 60, 4
# the CPU parity tolerances of tests/test_torch_train.py
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL_LRS = 1e-4, 3

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
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


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_vs_plain(bcsr, h: int, gen: torch.Generator, device) -> tuple:
    """(x, max |kernel - plain|, max |plain|); fails past the tolerance."""
    x = torch.randn(bcsr.n_node, h, generator=gen).to(device)
    out = bs.bcsr_spmm(bcsr, x)
    ref = bs.bcsr_spmm_reference(bcsr, x)
    sync(device)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    check(torch.isfinite(out).all().item(), f"non-finite kernel output at H={h}")
    check(err <= KERNEL_TOL * scale,
          f"kernel vs plain at H={h}: max|diff| {err} > {KERNEL_TOL} * {scale}")
    return x, err, scale


def nonzero_blocks(bcsr) -> int:
    """Stored 128x128 blocks that hold at least one nonzero (this data's
    work; the rest is CHUNK padding)."""
    b = bcsr.blocks.view(-1, BLOCK, bs.CHUNK, BLOCK)
    return int((b != 0).any(dim=3).any(dim=1).sum())


def bound_ms(bcsr, x) -> tuple:
    """(least time in ms, "bytes" | "operations") for out = A @ x on this
    card's published peaks: each input byte read once (nonzero blocks,
    their column ids, the row pointers, x), the output written once, and
    2 * 128 * 128 * H f32 operations per nonzero block."""
    nz = nonzero_blocks(bcsr)
    h = x.shape[1]
    nbytes = (nz * BLOCK * BLOCK * 4 + nz * 4 + (bcsr.n_rb + 1) * 4
              + 2 * x.numel() * 4)
    flops = 2.0 * nz * BLOCK * BLOCK * h
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
                  dropout: float = 0.0) -> GLASS:
    return GLASS(max_deg, EM_USER["hidden_dim"], EM_USER["conv_layer"], (1,),
                 (EM_USER["pool"],), activation=EM_USER["activation"],
                 z_ratio=EM_USER["z_ratio"], jk=EM_USER["jk"],
                 dropout=dropout, spmm_mode=spmm_mode, seed=0, device=device)


def phase_small(device) -> None:
    """The kernel on a small layout, and a small model card-vs-CPU."""
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
    for h in (17, 128):
        _, err, scale = kernel_vs_plain(bcsr, h, gen, device)
        emit("kernel_small", H=h, n_node=n, stored_blocks=bcsr.nnz_blocks,
             max_abs_err=err, max_abs_ref=scale)

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
    x, err, scale = kernel_vs_plain(bcsr, h, gen, device)
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
        ms=time_ms(lambda: bs.bcsr_spmm(bcsr, x)),
        plain_ms=time_ms(lambda: bs.bcsr_spmm_reference(bcsr, x)),
        library_ms=time_ms(lambda: torch.sparse.mm(adj, x)),
    )
    record["bound_ms"], record["bound_by"] = bound_ms(bcsr, x)
    emit("kernel_main", H=h, max_abs_err=err, max_abs_ref=scale,
         library_max_abs_diff=lib_err, ms=record["ms"],
         plain_ms=record["plain_ms"], library_ms=record["library_ms"],
         bound_ms=record["bound_ms"], bound_by=record["bound_by"])
    del adj, lib

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


def small_band_layouts(device) -> dict:
    """name -> BandedAdj for the kernel's cases; fails if a layout lacks
    the case it stands for."""
    rng = np.random.default_rng(11)
    ei, n = clustered_graph(12, BLOCK, 6000, seed=5)
    affine = build_graph(ei, None, n, "gcn", materialize_dense=False,
                         materialize_bcsr=True, sparse_layout="band",
                         device=device).band
    top = affine.n_groups - 1
    check(affine.affine_stride is not None and affine.affine_off < 0
          and top * affine.affine_stride + affine.affine_off
          + affine.w_blocks > affine.n_cb,
          "the affine layout lacks a negative offset or a bottom overhang")

    n = 16 * BLOCK
    per_group = build_graph(piecewise_edges(rng, n), None, n, "sum",
                            materialize_dense=False, materialize_bcsr=True,
                            sparse_layout="band", device=device).band
    check(per_group.affine_stride is None, "the affine gate took the jump")

    n = 10 * BLOCK + 37
    r = rng.integers(0, n, 4000)
    r = r[(r // BLOCK < 2) | (r // BLOCK > 3)]  # group 1 of rps 2 is empty
    c = np.clip(r + rng.integers(-200, 200, r.size), 0, n - 1)
    w = rng.uniform(0.5, 2.0, r.size).astype(np.float32)
    empty = build_graph(np.stack([r, c]), w, n, "sum",
                        materialize_dense=False, materialize_bcsr=True,
                        sparse_layout="band", band_rps=2, device=device).band
    check(bool((empty.slabs.abs().sum(dim=(1, 2)) == 0).any()),
          "the ragged layout has no empty group")
    return {"affine": affine, "per_group": per_group,
            "empty_groups_ragged": empty}


def nonzero_band_blocks(band) -> int:
    """128x128 blocks of the slabs that hold at least one nonzero (this
    data's work; the rest of the band is zeros)."""
    b = band.slabs.view(band.n_groups, band.rps, BLOCK, band.w_blocks, BLOCK)
    return int((b != 0).any(dim=4).any(dim=2).sum())


def band_bound_ms(band, x) -> tuple:
    """(least time in ms, "bytes" | "operations") for out = A @ x, counted
    as bound_ms counts it for BCSR: the nonzero blocks, the window table
    and x read once, the output written once, 2 * 128 * 128 * H f32
    operations per nonzero block."""
    nz = nonzero_band_blocks(band)
    h = x.shape[1]
    nbytes = nz * BLOCK * BLOCK * 4 + band.n_groups * 4 + 2 * x.numel() * 4
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * nz * BLOCK * BLOCK * h / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def band_vs_plain(band, x) -> tuple:
    """(max |kernel - plain|, max |plain|); fails past the tolerance or if a
    repeated call differs in any bit."""
    out = bd.band_spmm(band, x)
    again = bd.band_spmm(band, x)
    ref = bd.band_spmm_reference(band, x)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    check(torch.isfinite(out).all().item(), "non-finite band kernel output")
    check(torch.equal(out, again), "repeated band kernel call differs")
    check(err <= KERNEL_TOL * scale,
          f"band kernel vs plain: max|diff| {err} > {KERNEL_TOL} * {scale}")
    return err, scale


def phase_band_small(device) -> None:
    gen = torch.Generator().manual_seed(12)
    for name, band in small_band_layouts(device).items():
        for h in (17, 64, 128):
            x = torch.randn(band.n_node, h, generator=gen).to(device)
            err, scale = band_vs_plain(band, x)
            emit("kernel_band_small", layout=name, H=h, n_node=band.n_node,
                 rps=band.rps, w_blocks=band.w_blocks,
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


def small_training(device, layout: str):
    """(step losses, parameters on the CPU) of a small GLASS (dropout 0)
    after one 3-step epoch on an asymmetric graph."""
    ei, n = clustered_graph(8, BLOCK, 3000, seed=6)
    graph = build_graph(ei, None, n, "mean", materialize_dense=False,
                        materialize_bcsr=True, sparse_layout=layout,
                        device=device)
    check((graph.band if layout == "band" else graph.bcsr) is not None,
          f"the small training graph has no {layout} layout")
    feats = np.random.default_rng(7).integers(0, 6, (n, 1))
    model = GLASS(5, 16, 2, (1,), ("size",), dropout=0.0,
                  spmm_mode="pallas", seed=0, device=device)
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
    served on it. Returns the band kernel's record for the kernels line."""
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
    stored = band.n_groups * band.rps * band.w_blocks
    nz = nonzero_band_blocks(band)
    emit("graph_band", n_node=n, directed_edges=graph.n_edge, rps=band.rps,
         w_blocks=band.w_blocks, affine_stride=band.affine_stride,
         affine_off=band.affine_off, groups=band.n_groups,
         slab_bytes=band.slabs.numel() * 4, stored_blocks=stored,
         nonzero_blocks=nz, fill=nz / stored, build_s=build_s)

    h = EM_USER["hidden_dim"]
    x = torch.randn(n, h, generator=gen).to(device)
    err, scale = band_vs_plain(band, x)
    adj = csr_adjacency(graph)
    lib = torch.sparse.mm(adj, x)
    lib_err = float((lib - bd.band_spmm_reference(band, x)).abs().max())
    record = dict(
        name="band_spmm", route="cuda",
        source="glass_tpu_torch/csrc/band_spmm.cu",
        replaces="glass_tpu/ops/pallas_band.py:658", tpu=BAND_TPU,
        max_abs_err=err,
        ms=time_ms(lambda: bd.band_spmm(band, x)),
        plain_ms=time_ms(lambda: bd.band_spmm_reference(band, x)),
        library_ms=time_ms(lambda: torch.sparse.mm(adj, x)),
    )
    record["bound_ms"], record["bound_by"] = band_bound_ms(band, x)
    emit("kernel_band_main", H=h, max_abs_err=err, max_abs_ref=scale,
         library_max_abs_diff=lib_err, ms=record["ms"],
         plain_ms=record["plain_ms"], library_ms=record["library_ms"],
         bound_ms=record["bound_ms"], bound_by=record["bound_by"])
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
    bd.band_spmm.launches = bs.bcsr_spmm.launches = 0  # the path starts here
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
    check(bs.bcsr_spmm.launches == 0, "the band path launched the BCSR kernel")
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

    phase_small(device)
    records = [phase_main(device)]
    phase_band_small(device)
    phase_grad_small(device)
    phase_train_small(device)
    records.append(phase_band_main(device))

    for record in records:
        record["us"] = record["ms"] * 1e3
        record["library_us"] = record["library_ms"] * 1e3
        record["max_abs_diff"] = record["max_abs_err"]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

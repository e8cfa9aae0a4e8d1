#!/usr/bin/env python3
"""Drives the PyTorch/H100 port of GLASS serving on one CUDA card and checks it.

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

from glass_tpu_torch import GLASS, Predictor, build_graph
from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import bcsr_spmm as bs
from glass_tpu_torch.ops._common import BLOCK
from glass_tpu_torch.ops.graph import degrees

# glass_tpu/configs/em_user.yml; activation "elu" as the experiment protocol
# builds GLASS (glass_tpu/train/protocol.py::make_glass_model).
EM_USER = dict(hidden_dim=64, conv_layer=1, pool="size", z_ratio=0.75, jk=True,
               aggr="gcn", batch_size=6, activation="elu")
N_COMM, COMM_SIZE, UNDIRECTED_EDGES = 448, 128, 4_500_000
REQUEST_BATCHES = (1, EM_USER["batch_size"], 64)

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


def em_user_model(max_deg: int, spmm_mode: str, device) -> GLASS:
    return GLASS(max_deg, EM_USER["hidden_dim"], EM_USER["conv_layer"], (1,),
                 (EM_USER["pool"],), activation=EM_USER["activation"],
                 z_ratio=EM_USER["z_ratio"], jk=EM_USER["jk"],
                 spmm_mode=spmm_mode, seed=0, device=device)


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
    n_e = graph.n_edge
    with warnings.catch_warnings():  # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        adj = torch.sparse_coo_tensor(
            torch.stack([graph.row[:n_e], graph.col[:n_e]]),
            graph.weight[:n_e], (n, n), check_invariants=True,
        ).coalesce().to_sparse_csr()
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
    record = phase_main(device)

    record["us"] = record["ms"] * 1e3
    record["library_us"] = record["library_ms"] * 1e3
    record["max_abs_diff"] = record["max_abs_err"]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

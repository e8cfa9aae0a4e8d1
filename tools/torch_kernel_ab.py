#!/usr/bin/env python3
"""Times the SpMM, fused-GraphNorm and embedding-backward kernels of one
checkout at the main path's shapes.

Imports ``chip_smoke`` and ``glass_tpu_torch`` from ``--root`` (a checkout
of any commit of the port, e.g. one unpacked with ``git archive`` into a
directory that .gitignore lists). On one CUDA card it runs the five fused
GraphNorm passes at em_user's 57,344 x 64, f32 and bf16 x, on the
arguments the checkout's own chip_smoke.norm_case and pass_args build (the
same x and dy in every checkout), and one fused and one unfused eager
forward + backward of the norm; it builds the em_user stand-in graph of
chip_smoke.py in the banded-slab layout (rps 1) with f32, bf16 and int8
slabs and in the BCSR layout with f32, bf16 and int8 blocks, and the hpo
stand-in in the int8 dense layout. It prints one JSON line: the card, the
root, and each kernel's time (``norm_<pass>_<f32|bf16>``,
``norm_<affine|bwd_dx>_f32_component`` at component's 17,260 x 17,
``norm_fwd_bwd_<fused|unfused>_<f32|bf16>``; the SpMM kernels at H = 64,
bf16 x for the bf16 and int8 em_user layouts, f32 x otherwise, as
chip_smoke.py times them), three ways:

- ``<kernel>_ms``: chip_smoke.time_ms, CUDA events around back-to-back
  eager calls (median of groups): the wrapper's host work included where
  the card outruns it;
- ``<kernel>_device_ms``: the device time of one call, the median over
  DEVICE_REPS calls, each timed by CUDA events with the L2 cache flushed
  and the stream held by a spin kernel while the host enqueues it
  (chip_smoke.cold_ms's method): no host work, and no operand left in L2
  by the call before;
- ``<kernel>_host_us``: the host's time per call over HOST_CALLS eager
  calls without a synchronization, the median of HOST_GROUPS such runs
  (the card synchronized between them): the wrapper's enqueue cost when
  the card keeps up.

The fixed-order embedding backward (``ops/embedding.py``) is timed the
same three ways on f32 and bf16 cotangents of width 64 (``emb_<case>_<f32|
bf16>``), with ``torch.index_add`` of the f32 cotangent into a zero table
beside it (``emb_<case>_index_add``), on the id vectors of
``embedding_cases``: em_user's 57,344 degree ids, hpo's 14,587, 57,344
rows of one id, and the ladder's ids at 4x and 40x (229,376 and 2,293,760
over 16 values, tools/torch_max_scale.py's draw); each checkout builds its
own order. ``--kernels embedding`` times the embedding backward alone.

``--kernels step`` times instead em_user's captured training step on the
two routes of chip_smoke.py's ``[train_graph]`` (``default_route``: RCM,
the planner's layout; ``forced_band_fused_norm``), through the checkout's
own ``chip_smoke.em_user_training`` (one warm-up and TRAIN_EPOCHS - 1
timed epochs of 40 graphed steps on the host clock, each ending in a
readback, then one under the profiler for the device time a step),
STEP_RUNS times a route, each on a fresh model: ``step_<route>_ms``, the
median of the timed epochs' ms a step, with ``_epochs_ms`` (every timed
epoch) and ``_device_ms`` (the runs' device ms a step).

``--kernels sblock`` times the sparse-block SpMM (``ops/sblock_spmm.py``)
against BCSR f32 and ``torch.sparse.mm`` of the CSR matrix (the library's
product, which the port never calls) at the benchmark's two stand-in
shapes (``benchmark/configs``' hpo_metab and em_user graphs, seed
SBLOCK_SEED, gcn, H = 64, f32 x): ``<shape>_<sblock|bcsr|library>`` the
three ways above, with the layouts' sizes, the planner's choice and costs,
max |kernel - plain| over max |plain| (``<shape>_sblock_rel_err``,
``_vs_bcsr_rel_err``), whether two calls are bit-equal, and the wrapper's
launches. It needs a checkout that has the layout.

Two commits are compared by running it in turns within one call on one
card: parent, change, change, parent.

    python3 tools/torch_kernel_ab.py --root <checkout> \
        [--kernels all|embedding|step|sblock]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

DEVICE_REPS = 20
HOST_CALLS, HOST_GROUPS = 200, 5
L2_FLUSH_BYTES = 128 << 20  # past the H100's 50 MB L2
HEAD_START_CYCLES = 4_000_000  # about 2 ms of the card's clock
STEP_RUNS = 3  # em_user_training runs a route (--kernels step)
SBLOCK_SEED = 2147480001  # the stand-ins' seed (--kernels sblock)


def device_ms(torch, fn) -> float:
    """Device ms of one fn() with the L2 cache cold, the median over
    DEVICE_REPS calls: before each call a 128 MB fill and a spin kernel of
    about 2 ms, which holds the stream while the host enqueues the call
    between two CUDA events (chip_smoke.cold_ms's method, kept here so
    that every checkout is timed alike)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(DEVICE_REPS):
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


def embedding_cases(cs, ei, n):
    """(case, ids, n_ids) of the embedding backward: the em_user stand-in's
    degree ids, the hpo stand-in's, 57,344 rows of one id, and the
    ladder's ids at 4x and 40x (tools/torch_max_scale.py's draw)."""
    em = cs.degree_features(ei, n)[:, 0]
    yield "em_user", em, int(em.max()) + 1
    hpo_ei, hpo_n = cs.hpo_graph()
    hpo = cs.degree_features(hpo_ei, hpo_n)[:, 0]
    del hpo_ei
    yield "hpo", hpo, int(hpo.max()) + 1
    yield "one_id", em * 0, 1
    tool = cs.load_tool("torch_max_scale")
    for scale in (4, 40):
        yield (f"ladder_{scale}x",
               tool.rung_inputs(cs.N_COMM * scale * cs.COMM_SIZE, 1)[0][:, 0],
               tool.MAX_ID + 1)


def em_user_steps(torch, cs, device, ei, n, result) -> None:
    """em_user's graphed step on [train_graph]'s two routes over the
    stand-in (ei, n), built as chip_smoke.phase_train_graph builds them
    (module docstring)."""
    import numpy as np

    feats_np = cs.degree_features(ei, n)
    perm = cs.native.rcm_ordering(ei, n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    for route, edges, feats_r, layout, order in (
            ("default_route", inv[ei], feats_np[perm], "auto", perm),
            ("forced_band_fused_norm", ei, feats_np, "band", None)):
        graph = cs.build_graph(edges, None, n, cs.EM_USER["aggr"],
                               materialize_dense=False, materialize_bcsr=True,
                               sparse_layout=layout, device=device)
        feats = torch.from_numpy(feats_r).to(device)
        epochs, dev = [], []
        for _ in range(STEP_RUNS):
            with cs.fused_norm(order is None):
                run = cs.em_user_training(graph, feats, int(feats_np.max()),
                                          True, order)
            epochs += run["host_ms_per_step_epochs"][1:]
            dev.append(run["device_ms_per_step"])
            del run
        result[f"step_{route}_ms"] = statistics.median(epochs)
        result[f"step_{route}_epochs_ms"] = epochs
        result[f"step_{route}_device_ms"] = dev
        del graph, feats


def sblock_shapes(torch, cs, device, result, timed) -> None:
    """The sparse-block kernel, BCSR f32 and torch.sparse.mm at the
    benchmark's hpo_metab and em_user stand-ins (module docstring)."""
    import numpy as np

    from benchmark import generate as gen
    from glass_tpu_torch import build_graph
    from glass_tpu_torch.ops import bcsr_spmm as bs
    from glass_tpu_torch.ops import graph as tg
    from glass_tpu_torch.ops import sblock_spmm as sbm

    root = Path(__file__).resolve().parent.parent
    for shape in ("hpo_metab", "em_user"):
        cfg = json.loads((root / "benchmark" / "configs"
                          / f"{shape}.json").read_text())
        ei, n = gen.make_graph(cfg["graph"], SBLOCK_SEED)
        kw = dict(materialize_dense=False, materialize_bcsr=True,
                  device=device)
        auto = build_graph(ei, None, n, "gcn", **kw)
        result[f"{shape}_plan"] = auto.plan
        del auto
        sb = build_graph(ei, None, n, "gcn", sparse_layout="sblock", **kw)
        bc = build_graph(ei, None, n, "gcn", sparse_layout="bcsr", **kw)
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(np.searchsorted(sb.row.cpu().numpy(),
                                             np.arange(n + 1))),
            sb.col.cpu(), sb.weight.cpu(), (n, n)).to(device)
        x = torch.randn(n, 64, generator=torch.Generator().manual_seed(1)
                        ).to(device)
        layout = sb.sblock
        r_np, c_np, w_np = (t.cpu().numpy()[:sb.n_edge]
                            for t in (sb.row, sb.col, sb.weight))
        pattern = bs.block_pattern(r_np, c_np, w_np, layout.n_rb,
                                   layout.n_rb)
        result[f"{shape}_costs_us"] = {
            "sblock": tg._sblock_cost_model(n, pattern) * 1e6,
            "bcsr": tg._bcsr_cost_model(None, None, n, 4,
                                        pattern=pattern) * 1e6}
        result[f"{shape}_sblock_bytes"] = sum(
            t.numel() * t.element_size() for t in (
                layout.val, layout.row, layout.col, layout.row_off,
                layout.block_col, layout.block_row_ptr, layout.nz_ptr))
        result[f"{shape}_bcsr_bytes"] = \
            bc.bcsr.blocks.numel() * bc.bcsr.blocks.element_size()
        result[f"{shape}_nnz"] = layout.nnz
        result[f"{shape}_live_blocks"] = layout.live_blocks
        before = sbm.sblock_spmm.launches
        got = sbm.sblock_spmm(layout, x)
        again = sbm.sblock_spmm(layout, x)
        plain = sbm.sblock_spmm_reference(layout, x)
        ref_b = bs.bcsr_spmm_reference(bc.bcsr, x)
        scale = float(plain.abs().max())
        result[f"{shape}_sblock_rel_err"] = float(
            (got - plain).abs().max()) / scale
        result[f"{shape}_sblock_vs_bcsr_rel_err"] = float(
            (got - ref_b).abs().max()) / scale
        result[f"{shape}_sblock_bit_equal"] = bool(torch.equal(got, again))
        result[f"{shape}_sblock_launches"] = \
            sbm.sblock_spmm.launches - before
        del got, again, plain, ref_b
        timed(f"{shape}_sblock", lambda: sbm.sblock_spmm(layout, x))
        timed(f"{shape}_bcsr", lambda: bs.bcsr_spmm(bc.bcsr, x))
        timed(f"{shape}_library", lambda: torch.sparse.mm(csr, x))
        timed(f"{shape}_sblock_plain",
              lambda: sbm.sblock_spmm_reference(layout, x), cold=False)
        del sb, bc, csr, x, layout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose kernels are timed")
    ap.add_argument("--kernels", choices=("all", "embedding", "step",
                                          "sblock"),
                    default="all", help="every kernel, the embedding "
                    "backward alone, em_user's graphed training step, or "
                    "the sparse-block SpMM at the stand-in shapes")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as cs
    from glass_tpu_torch import build_graph
    from glass_tpu_torch.ops import band_spmm as bd
    from glass_tpu_torch.ops import bcsr_spmm as bs
    from glass_tpu_torch.ops import dense_q as dq
    from glass_tpu_torch.ops import embedding as eb
    from glass_tpu_torch.ops import fused_norm as fnorm
    from glass_tpu_torch.ops.norm import graph_norm

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    ei, n = cs.clustered_graph()
    x = torch.randn(n, cs.EM_USER["hidden_dim"],
                    generator=torch.Generator().manual_seed(1)).to(device)
    result = {"card": cs.card_line(), "root": args.root,
              "package": str(Path(bd.__file__).resolve().parents[1])}
    xb = x.to(torch.bfloat16)
    if args.kernels == "step":
        em_user_steps(torch, cs, device, ei, n, result)
        print(json.dumps(result), flush=True)
        return 0

    def timed(key, fn, cold=True):
        result[f"{key}_ms"] = cs.time_ms(fn)
        if cold:
            result[f"{key}_device_ms"] = device_ms(torch, fn)
        spans = []
        for _ in range(HOST_GROUPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            spans.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
        result[f"{key}_host_us"] = statistics.median(spans)

    if args.kernels == "sblock":
        sblock_shapes(torch, cs, device, result, timed)
        print(json.dumps(result), flush=True)
        return 0

    for case, ids_np, n_ids in embedding_cases(cs, ei, n):
        ids = torch.from_numpy(ids_np).to(device)
        order = eb.embedding_order(ids, n_ids)
        zeros = torch.zeros(n_ids, cs.EM_USER["hidden_dim"], device=device)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            g = torch.randn(ids.shape[0], cs.EM_USER["hidden_dim"],
                            generator=torch.Generator().manual_seed(79)
                            ).to(device, dtype)
            timed(f"emb_{case}_{tag}", lambda: eb.embedding_backward(order, g))
            if dtype == torch.float32:
                timed(f"emb_{case}_index_add",
                      lambda: torch.index_add(zeros, 0, ids, g))
            del g
        del order, ids
    if args.kernels == "embedding":
        print(json.dumps(result), flush=True)
        return 0
    n_norm, f_norm = n, cs.EM_USER["hidden_dim"]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        gen = torch.Generator().manual_seed(32)
        xn, dyn, vecs = cs.norm_case(gen, n_norm, f_norm, dtype, device)
        for k in fnorm.KERNELS:
            args = cs.pass_args(k, xn, dyn, vecs)
            run = getattr(fnorm, k)
            timed(f"norm_{k}_{tag}", lambda: run(*args))
        w, b = (torch.randn(f_norm, generator=gen).to(device) for _ in range(2))
        a = (torch.randn(f_norm, generator=gen) * 0.3 + 1).to(device)
        gy = torch.randn(n_norm, f_norm, generator=gen).to(device, dtype)
        for name, norm in (("fused", fnorm.fused_graph_norm),
                           ("unfused", graph_norm)):
            xk = xn.clone().requires_grad_()
            params = [p.clone().requires_grad_() for p in (w, b, a)]
            timed(f"norm_fwd_bwd_{name}_{tag}",
                  lambda: torch.autograd.grad(norm(xk, *params),
                                              [xk, *params], gy))
        del xn, dyn, vecs
    # K3 and K5 at component's 17,260 x 17 (glass_tpu/configs/component.yml)
    xn, dyn, vecs = cs.norm_case(torch.Generator().manual_seed(32), 17_260,
                                 cs.NARROW_H, torch.float32, device)
    for k in ("affine", "bwd_dx"):
        args = cs.pass_args(k, xn, dyn, vecs)
        run = getattr(fnorm, k)
        timed(f"norm_{k}_f32_component", lambda: run(*args))
    del xn, dyn, vecs
    for layout, dd in (("band", "f32"), ("band", "bf16"), ("band", "int8"),
                       ("bcsr", "f32"), ("bcsr", "bf16"), ("bcsr", "int8")):
        graph = build_graph(ei, None, n, cs.EM_USER["aggr"],
                            materialize_bcsr=True, sparse_layout=layout,
                            band_rps=1, dense_dtype=dd, device=device)
        v = x if dd == "f32" else xb
        if layout == "band":
            timed(f"band_{dd}", lambda: bd.band_spmm(graph.band, v))
        else:
            timed(f"bcsr_{dd}", lambda: bs.bcsr_spmm(graph.bcsr, v))
        del graph
    ei, n = cs.hpo_graph()
    graph = build_graph(ei, None, n, cs.HPO_METAB["aggr"],
                        materialize_dense=True, dense_dtype="int8",
                        device=device)
    x = torch.randn(n, cs.HPO_METAB["hidden_dim"],
                    generator=torch.Generator().manual_seed(1)).to(device)
    timed("dense_q", lambda: dq.dense_q_spmm(graph.dense_q, None, x))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Times the memory ring of the tensor-core SpMM kernels alone, and the
streaming loop of the fused GraphNorm's reductions alone, beside the whole
kernel, at the main path's shapes, to show what holds each back.

Each of ``csrc/dense_q_spmm.cu``, ``csrc/band_spmm.cu`` and
``csrc/bcsr_spmm.cu`` is built a second time with ``-DGLASS_RING_ONLY``, and
``csrc/graph_norm.cu`` with ``-DGLASS_NORM_STREAM_ONLY`` (the flags of
``glass_tpu_torch/ops/_build.py`` otherwise, into ``build/variants/``, all
builds started together). That build keeps the kernel's copies and drops
its arithmetic: the dense kernel streams q alone (no x tiles, no widening,
no wgmma); the f32 band and BCSR kernels fill their cp.async ring and
multiply nothing; the bf16 and int8 band and BCSR kernels stream their A
tiles through the TMA ring alone (no x tiles, no widening, no wgmma); the
norm reductions (K1, K2, K4) read and sum their rows and stop, without the
CTA's sum, the ticket or the last CTA's finish. Its output is wrong and
not checked; its time is the memory pipeline's. Both builds are loaded in
turn in place of the package's library and timed by chip_smoke.cold_ms
(device time by CUDA events, the L2 cache flushed before each call; an
empty kernel's time by the same method is ``empty_kernel_ms``):

- ``dense_q_spmm`` on the hpo stand-in's int8 dense layout (14,587 nodes,
  H = 64, f32 x), beside ``torch.matmul`` of q's bf16 copy;
- ``band_spmm`` on the em_user stand-in's band (rps 1, H = 64) with f32,
  bf16 and int8 slabs, and ``bcsr_spmm`` on its BCSR layout with f32, bf16
  and int8 blocks (f32 x for f32 layouts, bf16 x otherwise);
- ``norm_<colsum|varsum|bwd_reduce>_<f32|bf16>`` at em_user's 57,344 x 64
  (chip_smoke.norm_case's operands), and ``..._n1`` at one row, where the
  pass is its fixed cost.

The fused GraphNorm's elementwise passes, K3 (``affine``) and K5
(``bwd_dx``), are timed beside what bounds them, at em_user's 57,344 x 64
(f32 and bf16 x) and at component's 17,260 x 17 (f32 x; tag
``f32_component``), under ``ew_<call>_<tag>``, where call is ``affine``,
``bwd_dx``, ``addcmul`` (``torch.addcmul(h, x, g)``, f32: K3's function
in one PyTorch call), ``copy`` (``y.copy_(x)``: the card's own
elementwise stream, one read and one write) or ``empty`` (an empty
kernel, ``torch.cuda._sleep(1)``). Each has three times:

- ``dirty_ms``: chip_smoke.cold_ms as the kernels line takes it: a 128
  MB ``zero_()`` before each call, which leaves the L2 full of dirty
  lines that the call's own lines must evict (written back to HBM);
- ``clean_ms``: chip_smoke.cold_ms with ``clean``: the same ``zero_()``,
  then one read pass over another 128 MB buffer (``sum()``), so that the
  L2 holds clean lines only;
- ``eager_ms``: chip_smoke.time_ms (back-to-back eager calls).

``host_<pass>_<f32|bf16>`` splits a pass's host time per call (each
piece timed alone by chip_smoke.host_us: time.perf_counter over 200
calls, the median of 5 runs, in microseconds): ``checks`` (the wrapper's
operand checks, ``fused_norm._check``), ``alloc``
(``torch.empty_like(x)``), ``counters`` (``fused_norm._count``),
``guard_compare`` (x's device against the current one) and ``stream_raw``
(the raw stream handle, ``torch._C._cuda_getCurrentRawStream``), which
replaced ``guard_with`` (entering and leaving
``torch.cuda.device(x.device)``) and ``stream_object``
(``torch.cuda.current_stream().cuda_stream``), timed beside them;
``launch`` (the library's entry point called through ctypes on the
packed arguments the wrapper built, the kernel's launch included) and
``pass`` (the whole wrapper call). What ``pass`` holds beyond the pieces
its wrapper runs is the Python between them.

Prints one JSON line with the card's name and power limit. On one card:

    python3 tools/torch_kernel_variants.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# source -> the macro of its variant build
VARIANTS = {"dense_q_spmm": "GLASS_RING_ONLY", "band_spmm": "GLASS_RING_ONLY",
            "bcsr_spmm": "GLASS_RING_ONLY",
            "graph_norm": "GLASS_NORM_STREAM_ONLY"}


def build_ring_only(build_mod) -> dict:
    """source -> its library built with its VARIANTS macro."""
    nvcc = build_mod.find_nvcc()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src, macro in VARIANTS.items():
        lib = out / f"lib{src}-{macro.lower()}.so"
        procs[src] = (lib, subprocess.Popen(
            [nvcc, *build_mod.NVCC_FLAGS, f"-D{macro}", "-o", str(lib),
             str(build_mod.CSRC / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{src} variant: nvcc exit {proc.returncode}"
                               f"\n{log}")
        libs[src] = build_mod.open_library(src, lib)
    return libs


def time_both(build_mod, src: str, ring_only, fn,
              key: str = "ring_only_ms") -> dict:
    """fn's device time (chip_smoke.cold_ms) with the package's library
    and with the variant (under ``key``), swapped in ``build_mod``'s cache
    of loaded libraries, where every wrapper finds its library."""
    import chip_smoke as cs

    build_mod._LOADED.pop(src, None)
    result = {"kernel_ms": cs.cold_ms(fn)}
    build_mod._LOADED[src] = ring_only
    try:
        result[key] = cs.cold_ms(fn)
    finally:
        build_mod._LOADED.pop(src)
    return result


def guard_with(torch, x) -> None:
    with torch.cuda.device(x.device):
        pass


def launch_piece(build_mod, call):
    """A closure that repeats the library call ``call()`` makes through
    ``build_mod.launch`` (the same entry point and packed arguments)."""
    real = build_mod.launch
    seen = {}

    def spy(kernel, entry, index, *args):
        seen.update(entry=entry, args=args)
        real(kernel, entry, index, *args)

    build_mod.launch = spy
    try:
        seen["out"] = call()  # kept alive: the launches write into it
    finally:
        build_mod.launch = real
    return lambda: seen["entry"](*seen["args"])


def elementwise_passes(result: dict, device) -> None:
    """K3 and K5 beside the empty kernel, torch.addcmul and copy_ under the
    dirty and the clean flush, and their host split (module docstring)."""
    import torch

    import chip_smoke as cs
    from glass_tpu_torch.ops import _build
    from glass_tpu_torch.ops import fused_norm as fnorm

    full = cs.N_COMM * cs.COMM_SIZE, cs.EM_USER["hidden_dim"]
    component = 17_260, cs.NARROW_H  # glass_tpu/configs/component.yml
    for (n, f), dtype, tag in ((full, torch.float32, "f32"),
                               (full, torch.bfloat16, "bf16"),
                               (component, torch.float32, "f32_component")):
        x, dy, v = cs.norm_case(torch.Generator().manual_seed(32), n, f,
                                dtype, device)
        y = torch.empty_like(x)
        calls = {k: (lambda run=getattr(fnorm, k),
                     a=cs.pass_args(k, x, dy, v): run(*a))
                 for k in ("affine", "bwd_dx")}
        calls["copy"] = lambda: y.copy_(x)
        calls["empty"] = lambda: torch.cuda._sleep(1)
        if dtype == torch.float32:
            calls["addcmul"] = lambda: torch.addcmul(v["h"], x, v["g"])
        for name, call in calls.items():
            result[f"ew_{name}_{tag}"] = {
                "dirty_ms": cs.cold_ms(call),
                "clean_ms": cs.cold_ms(call, clean=True),
                "eager_ms": cs.time_ms(call)}
        if tag == "f32_component":
            continue
        idx = x.get_device()
        for k, others, vecs in (
                ("affine", (), (v["g"], v["h"])),
                ("bwd_dx", (dy,), (v["a"], v["c2"], v["c1"]))):
            launch = launch_piece(_build, calls[k])
            pieces = {
                "checks": lambda: fnorm._check(k, x, others, vecs),
                "guard_with": lambda: guard_with(torch, x),
                "guard_compare":
                    lambda: x.get_device() == torch._C._cuda_getDevice(),
                "stream_object":
                    lambda: torch.cuda.current_stream().cuda_stream,
                "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(idx),
                "alloc": lambda: torch.empty_like(x),
                "counters": lambda: fnorm._count(k, x),
                "launch": launch,
                "pass": calls[k]}
            result[f"host_{k}_{tag}"] = {
                name: cs.host_us(piece) for name, piece in pieces.items()}
        del x, dy, v, y


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from glass_tpu_torch import build_graph
    from glass_tpu_torch.ops import _build
    from glass_tpu_torch.ops import band_spmm as bd
    from glass_tpu_torch.ops import bcsr_spmm as bs
    from glass_tpu_torch.ops import dense_q as dq
    from glass_tpu_torch.ops import fused_norm as fnorm

    device = torch.device("cuda")
    libs = build_ring_only(_build)
    result = {"card": cs.card_line(),
              "empty_kernel_ms": cs.cold_ms(lambda: torch.cuda._sleep(1))}

    f_norm = cs.EM_USER["hidden_dim"]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for n, sfx in ((cs.N_COMM * cs.COMM_SIZE, ""), (1, "_n1")):
            xn, dyn, vecs = cs.norm_case(torch.Generator().manual_seed(32),
                                         n, f_norm, dtype, device)
            for k in fnorm.SUMS:
                args = cs.pass_args(k, xn, dyn, vecs)
                result[f"norm_{k}_{tag}{sfx}"] = time_both(
                    _build, "graph_norm", libs["graph_norm"],
                    lambda run=getattr(fnorm, k), a=args: run(*a),
                    key="stream_only_ms")
        del xn, dyn, vecs
    elementwise_passes(result, device)

    ei, n = cs.hpo_graph()
    layout = build_graph(ei, None, n, cs.HPO_METAB["aggr"],
                         materialize_dense=True, dense_dtype="int8",
                         device=device).dense_q
    x = torch.randn(n, cs.HPO_METAB["hidden_dim"],
                    generator=torch.Generator().manual_seed(1)).to(device)
    q_bf16 = layout.q.to(torch.bfloat16)
    x_pad = torch.zeros(layout.q.shape[1], x.shape[1], dtype=torch.bfloat16,
                        device=device)
    x_pad[:n] = x
    result["dense_q_spmm"] = time_both(
        _build, "dense_q_spmm", libs["dense_q_spmm"],
        lambda: dq.dense_q_spmm(layout, None, x))
    result["dense_q_spmm"]["library_ms"] = cs.cold_ms(
        lambda: torch.matmul(q_bf16, x_pad))
    del layout, q_bf16, x_pad

    ei, n = cs.clustered_graph()
    x = torch.randn(n, cs.EM_USER["hidden_dim"],
                    generator=torch.Generator().manual_seed(1)).to(device)
    for layout, dd in (("band", "f32"), ("band", "bf16"), ("band", "int8"),
                       ("bcsr", "f32"), ("bcsr", "bf16"), ("bcsr", "int8")):
        graph = build_graph(ei, None, n, cs.EM_USER["aggr"],
                            materialize_bcsr=True, sparse_layout=layout,
                            band_rps=1, dense_dtype=dd, device=device)
        v = x if dd == "f32" else x.to(torch.bfloat16)
        if layout == "band":
            fn = lambda g=graph, v=v: bd.band_spmm(g.band, v)  # noqa: E731
        else:
            fn = lambda g=graph, v=v: bs.bcsr_spmm(g.bcsr, v)  # noqa: E731
        src = f"{layout}_spmm"
        result[f"{src}_{dd}"] = time_both(_build, src, libs[src], fn)
        del graph
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

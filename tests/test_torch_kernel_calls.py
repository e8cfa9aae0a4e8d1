"""The one call path from the Python wrappers to the hand-written kernels
(``glass_tpu_torch/ops/_build.py``, ``ops/_common.py::on_card``): the table
of typed entry points against the sources' declarations, the build without
``nvcc``, the routing rule and the launch-failure error. Runs on the CPU;
no kernel is built. This file imports no JAX."""

from __future__ import annotations

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops import band_spmm as tband
from glass_tpu_torch.ops import bcsr_spmm as tbcsr
from glass_tpu_torch.ops import dense_q as tdq
from glass_tpu_torch.ops import embedding as temb
from glass_tpu_torch.ops import fused_norm as tnorm
from glass_tpu_torch.ops import graph as tgraph
from glass_tpu_torch.ops import hbm_probe as tprobe
from glass_tpu_torch.ops import sblock_spmm as tsb

DECLARATION = re.compile(r'extern\s+"C"\s+int\s+(glass_\w+)\s*\(([^)]*)\)')
POINTERS = (ctypes.c_void_p, ctypes.c_char_p)
SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


def declarations() -> dict:
    """source -> entry -> the C types of its parameters, parsed from every
    ``extern "C" int glass_*(...)`` of ``csrc/*.cu``."""
    out = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        found = DECLARATION.findall(path.read_text())
        out[path.stem] = {
            name: [" ".join(p.split()) for p in params.split(",")]
            for name, params in found}
    return out


def kind(param: str):
    """The ctypes class a parameter declaration takes: pointers as one
    kind, integer scalars by their width."""
    if "*" in param:
        return POINTERS
    scalar = " ".join(param.replace("const ", "").split()[:-1])
    return SCALARS[scalar]


def test_table_matches_the_sources_declarations():
    parsed = declarations()
    assert set(parsed) == set(_build.SOURCES)
    for src, entries in parsed.items():
        table = _build.SIGNATURES[src]
        assert set(table) == set(entries), src
        for name, params in entries.items():
            argtypes = table[name]
            assert len(argtypes) == len(params), (src, name)
            for param, argtype in zip(params, argtypes):
                want = kind(param)
                ok = argtype in want if isinstance(want, tuple) \
                    else argtype is want
                assert ok, (src, name, param, argtype)


def test_open_library_types_every_entry(monkeypatch):
    """open_library sets each entry's argtypes from the table and restype
    int, whatever path the library was loaded from."""
    class Lib:
        def __init__(self, path):
            self.path = path
            for entry in _build.SIGNATURES["graph_norm"]:
                setattr(self, entry, type("Fn", (), {})())

    monkeypatch.setattr(ctypes, "CDLL", Lib)
    lib = _build.open_library("graph_norm", "/variants/libgraph_norm.so")
    assert lib.path == "/variants/libgraph_norm.so"
    for entry, argtypes in _build.SIGNATURES["graph_norm"].items():
        fn = getattr(lib, entry)
        assert fn.argtypes is argtypes and fn.restype is ctypes.c_int


@pytest.mark.parametrize("src", _build.SOURCES)
def test_kernel_without_nvcc_raises(monkeypatch, tmp_path, src):
    """A CUDA call with no built kernel and no nvcc raises; nothing falls
    back to the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load(src)
    assert (_build.CSRC / f"{src}.cu").is_file()


@pytest.mark.parametrize("current", [0, 1])
def test_launch_failure_names_the_kernel_and_the_code(monkeypatch, current):
    """A nonzero code from the entry raises, naming the kernel and the
    code; the device guard is entered only off the current device."""
    entered = []

    class Guard:
        def __init__(self, index):
            entered.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    calls = []

    def entry(*args):
        calls.append(args)
        return 700

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    with pytest.raises(RuntimeError,
                       match="^sblock_spmm kernel launch failed: CUDA error "
                             "700$"):
        _build.launch("sblock_spmm", entry, 1, 3, b"args")
    assert calls == [(3, b"args")]
    assert entered == ([] if current == 1 else [1])
    _build.launch("sblock_spmm", lambda *a: 0, 1)  # code 0: no error


# ---------------------------------------------------------------- routing


def on_meta(obj):
    """A copy of a layout dataclass with every tensor field on ``meta``."""
    moved = {f.name: getattr(obj, f.name).to("meta")
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **moved)


def small_graph(**kw):
    rng = np.random.default_rng(0)
    n = 300
    ei = rng.integers(0, n, size=(2, 2000))
    ei = np.concatenate([ei, ei[::-1]], axis=1)
    return tgraph.build_graph(ei, None, n, "gcn", device="cpu", **kw), n


def spmm_call(layout: str):
    if layout == "dense_q":
        g, n = small_graph(materialize_dense=True, dense_dtype="int8")
        return lambda: tdq.dense_q_spmm(on_meta(g.dense_q), None,
                                        torch.zeros(n, 4, device="meta"))
    g, n = small_graph(materialize_bcsr=True, sparse_layout=layout,
                       materialize_dense=False)
    fn = {"bcsr": tbcsr.bcsr_spmm, "band": tband.band_spmm,
          "sblock": tsb.sblock_spmm}[layout]
    return lambda: fn(on_meta(getattr(g, layout)),
                      torch.zeros(n, 4, device="meta"))


def norm_call(name: str):
    x = torch.zeros(10, 4, device="meta")
    v = torch.zeros(4, device="meta")
    args = {"colsum": (x, v), "varsum": (x, v, v, v, v, v, 1e-5),
            "affine": (x, v, v), "bwd_reduce": (x, x, v, v, v, v, v, 1e-5),
            "bwd_dx": (x, x, v, v, v)}[name]
    return lambda: getattr(tnorm, name)(*args)


def embedding_call():
    order = temb.embedding_order(torch.tensor([0, 2, 2, 1]), 3)
    return lambda: temb.embedding_backward(on_meta(order),
                                           torch.zeros(4, 8, device="meta"))


def probe_call(name: str):
    x = torch.zeros(64, tprobe.LANES, device="meta")
    if name == "hbm_read":
        return lambda: tprobe.hbm_read(x, 16, 2, 1)
    return lambda: tprobe.hbm_read2([x, x], 16, 1)


WRAPPERS = {
    "bcsr_spmm": lambda: spmm_call("bcsr"),
    "band_spmm": lambda: spmm_call("band"),
    "sblock_spmm": lambda: spmm_call("sblock"),
    "dense_q_spmm": lambda: spmm_call("dense_q"),
    **{k: (lambda k=k: norm_call(k)) for k in tnorm.KERNELS},
    "embedding_backward": embedding_call,
    "hbm_read": lambda: probe_call("hbm_read"),
    "hbm_read2": lambda: probe_call("hbm_read2"),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_a_device_that_is_neither_cpu_nor_cuda(name):
    call = WRAPPERS[name]()
    with pytest.raises(ValueError,
                       match=f"^{name} runs on 'cuda' or 'cpu', not meta$"):
        call()

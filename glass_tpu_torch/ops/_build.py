"""Builds the package's CUDA sources into plain C-ABI shared libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/glass_tpu_torch/lib<name>-<digest>.so`` at first use and loaded with
``ctypes``. The digest covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt. The sources
include no PyTorch header: a build takes seconds.

It is also every wrapper's one way to a kernel: :data:`SIGNATURES` types
each ``extern "C"`` entry point of each source once, when :func:`load`
opens its library, and :func:`launch` calls an entry on a tensor's device
and turns a nonzero CUDA error code into one ``RuntimeError``. A new
kernel's entry points are typed in :data:`SIGNATURES`.

Nothing here runs at import time; a missing ``nvcc`` raises when a kernel is
first needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "glass_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the log
)
_P, _I = ctypes.c_void_p, ctypes.c_int
# glass_launches(unsigned long long* out, int reset): a library's device
# launch counters
_LAUNCHES = [_P, _I]
# source -> its extern "C" entry points -> their argtypes; every entry
# returns an int (a CUDA error code; glass_norm_sm_count an SM count).
# The norm and embedding entries take one packed struct: their kernels are
# short, so the host's per-call cost shows beside them, and ctypes converts
# one argument in place of 14 to 18.
SIGNATURES = {
    "bcsr_spmm": {
        "glass_bcsr_spmm": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P,
                            _I, _I, _I, _P],
        "glass_launches": _LAUNCHES},
    "band_spmm": {
        "glass_band_spmm": [_P, _I, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I,
                            _I, _I, _I, _P],
        "glass_launches": _LAUNCHES},
    "dense_q_spmm": {
        "glass_dense_q_spmm": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "glass_launches": _LAUNCHES},
    "graph_norm": {
        "glass_norm_sm_count": [_I],
        "glass_norm_reduce": [ctypes.c_char_p],
        "glass_norm_elementwise": [ctypes.c_char_p],
        "glass_launches": _LAUNCHES},
    "hbm_probe": {
        "glass_hbm_read": [_P, _I, ctypes.c_longlong, _I, _I, _I, _I, _P, _I,
                           _I, _P]},
    "embedding_bwd": {
        "glass_embedding_bwd": [ctypes.c_char_p],
        "glass_launches": _LAUNCHES},
    "sblock_spmm": {
        "glass_sblock_spmm": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
        "glass_launches": _LAUNCHES},
}
SOURCES = tuple(SIGNATURES)
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, then ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``; raises if none has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    for base in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if base and (Path(base) / "bin" / "nvcc").is_file():
            return str(Path(base) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin: "
        "the package's CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compiles every named source that has no up-to-date library, with one
    ``nvcc`` per source, all started together. Returns name -> library path.
    Each build's compiler output is kept beside its library as ``.log``."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = paths[name].with_name(f"{paths[name].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return paths


def open_library(name: str, path) -> ctypes.CDLL:
    """The library at ``path``, a build of ``csrc/<name>.cu`` (the
    package's or a variant's), its entry points typed by SIGNATURES."""
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def load(name: str) -> ctypes.CDLL:
    """The typed library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = open_library(name, build((name,))[name])
        _LOADED[name] = lib
    return lib


def launch(kernel: str, entry, index: int, *args) -> None:
    """``entry(*args)``, a typed entry point, on cuda:``index``, the
    current device made that one only where it is not: a device guard costs
    about what the launch does (tools/torch_kernel_variants.py ``host_*``),
    and torch._C's current-device read half of
    torch.cuda.current_device(). Raises ``RuntimeError`` naming ``kernel``
    on a nonzero CUDA error."""
    if index == torch._C._cuda_getDevice():
        rc = entry(*args)
    else:
        with torch.cuda.device(index):
            rc = entry(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")

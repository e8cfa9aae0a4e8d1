"""Builds the package's CUDA sources into plain C-ABI shared libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/glass_tpu_torch/lib<name>-<digest>.so`` at first use and loaded with
``ctypes``. The digest covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt. The sources
include no PyTorch header: a build takes seconds.

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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "glass_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the log
)
SOURCES = ("bcsr_spmm", "band_spmm", "dense_q_spmm", "graph_norm", "hbm_probe",
           "embedding_bwd", "sblock_spmm")
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _LOADED[name] = lib
    return lib

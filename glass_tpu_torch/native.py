"""ctypes bindings of the native host library (counterpart of
``glass_tpu/native.py``).

The port builds its own copy of the host library's source,
``glass_tpu_torch/csrc/glass_host.cpp``, with ``g++``, at first use: into
``build/glass_tpu_torch/libglass_host-<digest>.so``, the digest covering
the source, the flags, the compiler's path and its ``--version``
(the RCM order's ties fall as the compiler's ``std::sort`` breaks them, so
another compiler builds a library of its own), the compiler's output kept
beside it as ``.log`` (as ``ops/_build.py`` builds the CUDA sources).
The flags are the Makefile's without ``-march=native``: the tracked
``native/libglass_host.so`` was built for another host's CPU and is
neither loaded nor rebuilt here.
Where the compiler has no OpenMP runtime (a g++ without ``libgomp``), the
library is built without ``-fopenmp``: the source's parallel sections
(``__gnu_parallel::sort`` of unique keys, the band fill by whole groups)
give the serial results bit for bit, so only the speed differs.

Bound: ``build_csr`` (sort + degree + normalization of ``build_graph``),
``rcm_ordering`` (reverse Cuthill-McKee), ``band_fill`` and ``bcsr_fill``
(the block-sparse layouts' fills), and three entry points of the port's
own that the lean build of a large graph runs on its row-sorted int32
edge arrays: ``col_order`` (the stable order of the edges by column, for
the symmetry test), ``block_counts`` (each row block's nonzero column
blocks, for the planner and the BCSR build) and ``bcsr_fill_rows`` (the
BCSR fill over the edges in their row order), ``negative_sample`` (the non-edges
of the link-prediction dataset) and ``induced_subgraph_adj`` (GNN-seg's
dense per-subgraph adjacencies). Each returns what the JAX package's
binding returns, byte for byte; where ``g++`` is missing or the build or
the load fails, one warning is given and every function takes the numpy or
scipy branch the JAX package falls back to (``negative_sample`` returns
None, and ``BaseGraphData.get_lp_dataset`` samples in numpy;
``induced_subgraph_adj`` returns None, and ``data/seg.py::segregate``
builds the adjacencies in numpy).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from glass_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "glass_host.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-fopenmp", "-shared")
SERIAL_FLAGS = tuple(f for f in CXX_FLAGS if f != "-fopenmp")

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "glass_build_csr": [_I64, _I64, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int, _I32, _I32, _F32, _F64],
    "glass_rcm": [_I64, _I64, ctypes.c_int64, ctypes.c_int64, _I64],
    "glass_band_fill": [_I64, _I64, _F64, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_int64, _I32, ctypes.c_int64, _F32],
    "glass_bcsr_fill": [_I64, _I64, _F64, _I64, ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int64, _F32],
    "glass_negative_sample": [_I64, _I64, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_uint64, _I64, _I64],
    "glass_induced_subgraphs": [_I64, _I64, ctypes.c_int64, ctypes.c_int64,
                                _I64, ctypes.c_int64, ctypes.c_int64, _F32],
    "glass_col_order": [_I32, ctypes.c_int64, ctypes.c_int64, _I32],
    "glass_block_counts": [_I32, _I32, _F32, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int64, _I64, ctypes.c_void_p,
                           ctypes.c_void_p],
    "glass_bcsr_fill_rows": [_I32, _I32, _F32, ctypes.c_int64,
                             ctypes.c_int64, ctypes.c_int64, _I64, _I32, _I32,
                             ctypes.c_int64, ctypes.c_int64, _F32],
}

_LIB: Optional[ctypes.CDLL] = None
_SEARCHED = False


def compiler() -> Tuple[str, str]:
    """The compiler (``$CXX`` or ``g++``, as a path) and its ``--version``
    output. Raises ``RuntimeError`` when there is none."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX or g++) on PATH")
    proc = subprocess.run([cxx, "--version"], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return cxx, proc.stdout


def library_path(flags=CXX_FLAGS, cxx: Optional[Tuple[str, str]] = None
                 ) -> Path:
    """Where the library built by ``cxx`` (:func:`compiler`'s pair; the
    current compiler by default) with ``flags`` lies."""
    path, version = cxx or compiler()
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()
                            + f"\0{path}\0{version}".encode()).hexdigest()
    return BUILD_DIR / f"libglass_host-{digest[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if it is not there (``$CXX`` or
    ``g++``; with CXX_FLAGS, else SERIAL_FLAGS where the compiler refuses
    ``-fopenmp``). Raises ``RuntimeError`` when there is no compiler or
    neither build succeeds."""
    cxx = compiler()
    for flags in (CXX_FLAGS, SERIAL_FLAGS):
        if library_path(flags, cxx).exists():
            return library_path(flags, cxx)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = []
    for flags in (CXX_FLAGS, SERIAL_FLAGS):
        path = library_path(flags, cxx)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx[0], *flags, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        path.with_suffix(".log").write_text(proc.stdout)
        if proc.returncode == 0:
            os.replace(tmp, path)  # atomic: concurrent builders agree
            return path
        tmp.unlink(missing_ok=True)
        logs.append(f"{cxx[0]} {' '.join(flags)}: exit {proc.returncode}\n"
                    f"{proc.stdout}")
    raise RuntimeError(f"building {SOURCE.name} failed:\n" + "\n".join(logs))


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    try:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    except (OSError, RuntimeError, AttributeError) as err:
        warnings.warn(f"native host library unavailable ({err}); the numpy "
                      "and scipy branches run instead", RuntimeWarning)
        return None
    _LIB = lib
    return lib


def is_available() -> bool:
    return _load() is not None


AGGR_CODES = {"sum": 0, "mean": 1, "gcn": 2}


def build_csr(edge_index: np.ndarray, edge_weight: Optional[np.ndarray],
              n_node: int, aggr: str, pad_to: Optional[int] = None,
              ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Edges sorted by (row, col), ties in input order, and their normalized
    weights: (row int32, col int32, weight f32); None without the library.
    ``pad_to``: the arrays' length, past the edges zero-weight edges on the
    last node (``build_graph``'s padding), written in place."""
    lib = _load()
    if lib is None:
        return None
    row = np.ascontiguousarray(edge_index[0], dtype=np.int64)
    col = np.ascontiguousarray(edge_index[1], dtype=np.int64)
    e = row.shape[0]
    length = max(e, pad_to or 0)
    out_row = np.empty(length, dtype=np.int32)
    out_col = np.empty(length, dtype=np.int32)
    out_w = np.empty(length, dtype=np.float32)
    out_deg = np.empty(n_node, dtype=np.float64)
    weight = (None if edge_weight is None
              else np.ascontiguousarray(edge_weight, dtype=np.float32))
    wptr = None if weight is None else weight.ctypes.data_as(ctypes.c_void_p)
    rc = lib.glass_build_csr(row, col, wptr, e, n_node, AGGR_CODES[aggr],
                             out_row[:e], out_col[:e], out_w[:e], out_deg)
    if rc != 0:
        raise RuntimeError(f"glass_build_csr failed with {rc}")
    out_row[e:] = n_node - 1
    out_col[e:] = n_node - 1
    out_w[e:] = 0.0
    return out_row, out_col, out_w


def _int32_edges(*arrays) -> bool:
    """True when every array is a C-contiguous int32 one of under 2^31
    entries: what the lean entry points take."""
    return all(a.dtype == np.int32 and a.flags.c_contiguous
               and a.shape[0] < 2**31 for a in arrays)


def col_order(col: np.ndarray, n_node: int) -> Optional[np.ndarray]:
    """The stable order of the edges by column (``np.argsort(col,
    kind="stable")``) as int32; None without the library or where ``col``
    is not a contiguous int32 array."""
    lib = _load()
    if lib is None or not _int32_edges(col):
        return None
    out = np.empty(col.shape[0], dtype=np.int32)
    if lib.glass_col_order(col, col.shape[0], n_node, out) != 0:
        raise ValueError(f"columns outside [0, {n_node})")
    return out


def block_counts(row: np.ndarray, col: np.ndarray, weight: np.ndarray,
                 n_rb: int, n_cb: int) -> Optional[tuple]:
    """The nonzero 128 x 128 blocks of a row-sorted edge list (the edges of
    nonzero weight): (ptr (n_rb + 1,) int64, column blocks int32, edges a
    block int64), row block rb's column blocks ascending at [ptr[rb],
    ptr[rb + 1]). None without the library, where the arrays are not
    contiguous int32 (row, col) and f32 (weight), or where the rows are not
    sorted."""
    lib = _load()
    if lib is None or not _int32_edges(row, col) or \
            weight.dtype != np.float32 or not weight.flags.c_contiguous:
        return None
    e = row.shape[0]
    ptr = np.zeros(n_rb + 1, dtype=np.int64)
    rc = lib.glass_block_counts(row, col, weight, e, n_rb, n_cb, ptr[1:],
                                None, None)
    if rc == 2:
        return None
    if rc != 0:
        raise ValueError(f"columns outside [0, {n_cb * 128})")
    np.cumsum(ptr, out=ptr)
    cb = np.empty(int(ptr[-1]), dtype=np.int32)
    cnt = np.empty(int(ptr[-1]), dtype=np.int64)
    rc = lib.glass_block_counts(row, col, weight, e, n_rb, n_cb, ptr,
                                cb.ctypes.data_as(ctypes.c_void_p),
                                cnt.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"glass_block_counts failed with {rc}")
    return ptr, cb, cnt


def bcsr_fill_rows(row: np.ndarray, col: np.ndarray, weight: np.ndarray,
                   blk_ptr: np.ndarray, blk_cb: np.ndarray,
                   slot_ptr: np.ndarray, n_cb: int, chunk: int,
                   n_store: int) -> Optional[np.ndarray]:
    """(n_store, 128, chunk*128) f32 wide chunks of a row-sorted int32 edge
    list with :func:`block_counts`' table (``blk_ptr``, ``blk_cb``; ``n_cb``
    column blocks), row block rb's blocks stored from slot ``slot_ptr[rb]``
    on and zero to ``slot_ptr[rb + 1]``: the chunks :func:`bcsr_fill` gives the edges
    sorted by block, summed in f64 in edge order. None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((n_store, 128, chunk * 128), dtype=np.float32)
    rc = lib.glass_bcsr_fill_rows(row, col, weight, row.shape[0],
                                  slot_ptr.shape[0] - 1, n_cb, blk_ptr,
                                  blk_cb, slot_ptr, chunk, n_store,
                                  out.reshape(-1))
    if rc != 0:
        raise RuntimeError(f"glass_bcsr_fill_rows failed with {rc}")
    return out


def rcm_ordering(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (perm[i] = old id at new slot i) of
    an undirected edge list; scipy's without the library."""
    row = np.ascontiguousarray(edge_index[0], dtype=np.int64)
    col = np.ascontiguousarray(edge_index[1], dtype=np.int64)
    lib = _load()
    if lib is not None:
        out = np.empty(n_node, dtype=np.int64)
        rc = lib.glass_rcm(row, col, row.shape[0], n_node, out)
        if rc != 0:
            raise RuntimeError(f"glass_rcm failed with {rc}")
        return out
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = coo_matrix((np.ones(row.shape[0]), (row, col)), shape=(n_node, n_node))
    return reverse_cuthill_mckee(m.tocsr(), symmetric_mode=True).astype(np.int64)


def band_fill(row: np.ndarray, col: np.ndarray, weight: np.ndarray, rps: int,
              w_blocks: int, clo: np.ndarray, n_g: int) -> Optional[np.ndarray]:
    """(n_g, rps*128, w_blocks*128) f32 slabs, summed in f64 in edge order
    (the numpy bincount's sums), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    weight = np.ascontiguousarray(weight, dtype=np.float64)
    clo = np.ascontiguousarray(clo, dtype=np.int32)
    out = np.empty((n_g, rps * 128, w_blocks * 128), dtype=np.float32)
    rc = lib.glass_band_fill(row, col, weight, row.shape[0], rps, w_blocks,
                             clo, n_g, out.reshape(-1))
    if rc != 0:
        raise RuntimeError(f"glass_band_fill failed with {rc}")
    return out


def bcsr_fill(row: np.ndarray, col: np.ndarray, weight: np.ndarray,
              e_dst: np.ndarray, chunk: int,
              n_store: int) -> Optional[np.ndarray]:
    """(n_store, 128, chunk*128) f32 wide chunks, edge i added at its
    block's slot ``e_dst[i]``, summed in f64 in edge order, or None without
    the library."""
    lib = _load()
    if lib is None:
        return None
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    weight = np.ascontiguousarray(weight, dtype=np.float64)
    e_dst = np.ascontiguousarray(e_dst, dtype=np.int64)
    out = np.empty((n_store, 128, chunk * 128), dtype=np.float32)
    rc = lib.glass_bcsr_fill(row, col, weight, e_dst, row.shape[0], chunk,
                             n_store, out.reshape(-1))
    if rc != 0:
        raise RuntimeError(f"glass_bcsr_fill failed with {rc}")
    return out


def negative_sample(edge_index: np.ndarray, n_node: int, e_neg: int,
                    seed: int) -> Optional[np.ndarray]:
    """(2, e_neg) int64 sampled non-edges (a, b), a != b, none an edge and
    none twice, drawn by mt19937_64 from ``seed``; None without the
    library. Raises ``RuntimeError`` when the graph is too dense to give
    ``e_neg`` of them."""
    lib = _load()
    if lib is None:
        return None
    row = np.ascontiguousarray(edge_index[0], dtype=np.int64)
    col = np.ascontiguousarray(edge_index[1], dtype=np.int64)
    src = np.empty(e_neg, dtype=np.int64)
    dst = np.empty(e_neg, dtype=np.int64)
    rc = lib.glass_negative_sample(row, col, row.shape[0], n_node, e_neg,
                                   seed, src, dst)
    if rc != 0:
        raise RuntimeError("negative sampling could not find enough non-edges")
    return np.stack([src, dst])


def induced_subgraph_adj(edge_index: np.ndarray, n_node: int,
                         pos: np.ndarray) -> Optional[np.ndarray]:
    """(S, L, L) f32 dense induced adjacencies of the padded subgraphs
    ``pos`` (S, L), pad -1 after a row's members: 1.0 per directed edge
    between members, a repeated edge counted each time; None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    row = np.ascontiguousarray(edge_index[0], dtype=np.int64)
    col = np.ascontiguousarray(edge_index[1], dtype=np.int64)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    if pos.ndim != 2:
        raise ValueError(f"pos must be (S, L), got shape {pos.shape}")
    for name, ids in (("edge_index", edge_index), ("pos", pos[pos >= 0])):
        if ids.size and (ids.min() < 0 or ids.max() >= n_node):
            raise ValueError(f"{name} holds node ids outside [0, {n_node})")
    s, width = pos.shape
    out = np.zeros((s, width, width), dtype=np.float32)
    rc = lib.glass_induced_subgraphs(row, col, row.shape[0], n_node, pos, s,
                                     width, out.reshape(-1))
    if rc != 0:
        raise RuntimeError(f"glass_induced_subgraphs failed with {rc}")
    return out

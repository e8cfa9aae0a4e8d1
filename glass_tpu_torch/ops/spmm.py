"""Sparse matrix x dense matrix product ``A @ x`` (message passing).

Counterpart of the unsharded dispatch of ``glass_tpu/ops/spmm.py``, with the
same mode strings so that configs carry over:

- ``dense``   : ``torch.matmul`` with the dense adjacency, TF32 off (a bf16
  matrix multiplies bf16 x, widened, into an f32 sum), or the int8 dense
  kernel (``ops/dense_q.py``) when the graph holds the int8 layout;
- ``segment`` : gather sources, ``index_add_`` into destination rows;
- ``band``    : the banded-slab kernel (``ops/band_spmm.py``);
- ``pallas``  : whichever block-sparse layout the graph holds, banded slabs
  or chunked BCSR (``ops/bcsr_spmm.py``), or both summed (the hybrid
  split), as the JAX dispatch does; where the layout planner chose the
  dense or the segment path (``Graph.plan``), that path;
- ``hybrid``  : ``A_band @ x + A_out @ x``, the band and BCSR kernels of the
  hybrid split.

The block-sparse and int8 modes are differentiable in x: the backward runs
the same kernel over the graph's transposed layout (the hybrid's two parts
each over their own, so dx = A_band^T g + A_out^T g). Every mode returns
f32, whatever x's dtype (the JAX dispatch's ``preferred_element_type``).
Where the JAX dispatch falls back from ``pallas`` to the dense or segment
path whenever the graph holds no block-sparse layout, this one does so only
where the planner chose that path, and raises otherwise: a run that asked
for a kernel gets the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from glass_tpu_torch.ops.band_spmm import band_spmm
from glass_tpu_torch.ops.bcsr_spmm import bcsr_spmm
from glass_tpu_torch.ops.dense_q import dense_q_spmm
from glass_tpu_torch.ops.graph import Graph


def spmm_dense(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x with the materialized dense adjacency, or the int8 dense
    layout when the graph holds that instead (``glass_tpu/ops/spmm.py``
    ``spmm_dense``). An f32 matrix multiplies x in full f32; a bf16 matrix
    multiplies x rounded to bf16, both widened to f32, so the products are
    exact and the sum is f32, as ``preferred_element_type=f32`` gives it (a
    plain product outside any TPU kernel in the JAX package too)."""
    if graph.dense is None and graph.dense_q is not None:
        return dense_q_spmm(graph.dense_q, graph.dense_q_t, x)
    if graph.dense is None:
        raise ValueError("graph was built without a dense adjacency")
    if graph.dense.dtype == torch.bfloat16:
        return torch.matmul(graph.dense.float(),
                            x.to(torch.bfloat16).float())
    return torch.matmul(graph.dense, x.float())


def spmm_segment(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """out[row] += weight * x[col], in f32 (a bf16 x is widened, as the JAX
    product with the f32 weights promotes it). On a CUDA tensor
    ``index_add_`` adds with atomics, so the order of the sum (and its last
    bits) varies by run. On the CPU both directions are bit-reproducible:
    the gather is an ``index_select``, whose backward is an ``index_add_``
    (advanced indexing's backward accumulates in a varying order there)."""
    x = x.float()
    out = x.new_zeros((graph.n_node, x.shape[1]))
    return out.index_add_(0, graph.row,
                          x.index_select(0, graph.col) * graph.weight[:, None])


def spmm(graph: Graph, x: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
    """Computes ``A @ x`` with the normalized adjacency held by ``graph``.

    Args:
      graph: a :class:`Graph`.
      x: (n_node, F) node features.
      mode: "dense" | "segment" | "band" | "hybrid" | "pallas" | None
        (dense if the graph holds a dense adjacency or the int8 dense
        layout, else segment).
    """
    if mode is None:
        has_dense = graph.dense is not None or graph.dense_q is not None
        mode = "dense" if has_dense else "segment"
    if mode == "pallas":
        if graph.band is not None:
            mode = "hybrid" if graph.bcsr is not None else "band"
        elif graph.bcsr is None and graph.plan in ("dense", "segment"):
            mode = graph.plan  # the planner declined every kernel layout
    if mode == "dense":
        return spmm_dense(graph, x)
    if mode == "segment":
        return spmm_segment(graph, x)
    if mode == "hybrid":
        if graph.band is None or graph.bcsr is None:
            raise ValueError(
                "spmm mode 'hybrid' needs both parts of a hybrid split: build "
                "the graph with materialize_bcsr=True, sparse_layout='hybrid'")
        return (band_spmm(graph.band, x, graph.band_t)
                + bcsr_spmm(graph.bcsr, x, graph.bcsr_t))
    if mode == "band":
        if graph.band is None:
            raise ValueError(
                "spmm mode 'band' needs a banded layout: build the graph with "
                "materialize_bcsr=True, sparse_layout='band'")
        return band_spmm(graph.band, x, graph.band_t)
    if mode == "pallas":
        if graph.bcsr is None:
            raise ValueError(
                "spmm mode 'pallas' needs a block-sparse layout: build the "
                "graph with materialize_bcsr=True")
        return bcsr_spmm(graph.bcsr, x, graph.bcsr_t)
    if mode == "ring":
        raise NotImplementedError(
            "spmm mode 'ring' is the sharded path, ROADMAP Queue 1 item 12 "
            "(not ported yet)")
    raise ValueError(f"unknown spmm mode {mode!r}")

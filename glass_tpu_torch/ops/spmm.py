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
  split), as the JAX dispatch does, or the port's sparse blocks
  (``ops/sblock_spmm.py``); where the layout planner chose the dense or
  the segment path (``Graph.plan``), that path;
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

Sharded graphs (``graph.axis`` set; ``glass_tpu/ops/spmm.py:29-210``):
x is this rank's (n_node, F) block of the node features. The dense and
block-sparse modes run on the features all-gathered over the graph axis
(:func:`gather_global`, whose backward reduce-scatters dx back to the
blocks), each rank's rectangular layout giving its own rows; "segment"
adds the own-block edges (``loc_*``) from x itself and the others from the
gathered features; "ring" (or "segment" on a graph with ring buckets)
streams the other blocks around the ring instead of gathering them.
"""

from __future__ import annotations

from typing import Optional

import torch

from glass_tpu_torch.ops._common import spmm_with_transpose
from glass_tpu_torch.ops.band_spmm import band_spmm
from glass_tpu_torch.ops.bcsr_spmm import bcsr_spmm
from glass_tpu_torch.ops.collectives import gather_rows, ring_shift
from glass_tpu_torch.ops.dense_q import dense_q_spmm
from glass_tpu_torch.ops.graph import Graph
from glass_tpu_torch.ops.sblock_spmm import sblock_spmm


def spmm_launches() -> tuple:
    """(launches, transposed): the SpMM kernels' launch counters summed
    (BCSR, band, sparse-block and int8 dense; a wrapper counts on a card,
    when called), and of them the backward's over a transposed layout
    (``_common.spmm_with_transpose``). A difference of two readings counts
    the launches of the code between them."""
    return (bcsr_spmm.launches + band_spmm.launches + sblock_spmm.launches
            + dense_q_spmm.launches, spmm_with_transpose.transposed_launches)


def gather_global(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """The globally indexed node features: x itself unsharded; sharded, the
    blocks all-gathered over ``graph.axis`` in rank order (the halo
    exchange), directly indexable by global node id because the blocks are
    contiguous and only the last is padded. Differentiable: the backward is
    a reduce-scatter (sum), the transpose of JAX's tiled all-gather."""
    return gather_rows(x, graph.axis)


def spmm_dense(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x with the materialized dense adjacency (this block's rows
    when sharded, on the gathered features), or the int8 dense layout when
    the graph holds that instead (``glass_tpu/ops/spmm.py`` ``spmm_dense``).
    An f32 matrix multiplies x in full f32; a bf16 matrix multiplies x
    rounded to bf16, both widened to f32, so the products are exact and the
    sum is f32, as ``preferred_element_type=f32`` gives it (a plain product
    outside any TPU kernel in the JAX package too)."""
    if graph.dense is None and graph.dense_q is not None:
        return dense_q_spmm(graph.dense_q, graph.dense_q_t,
                            gather_global(graph, x))
    if graph.dense is None:
        raise ValueError("graph was built without a dense adjacency")
    xg = gather_global(graph, x)
    if graph.dense.dtype == torch.bfloat16:
        return torch.matmul(graph.dense.float(),
                            xg.to(torch.bfloat16).float())
    return torch.matmul(graph.dense, xg.float())


def _segment_sum(n: int, row, col, weight, x: torch.Tensor) -> torch.Tensor:
    """out[row] += weight * x[col] over n rows, in f32."""
    x = x.float()
    out = x.new_zeros((n, x.shape[1]))
    return out.index_add_(0, row, x.index_select(0, col) * weight[:, None])


def spmm_segment(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """out[row] += weight * x[col], in f32 (a bf16 x is widened, as the JAX
    product with the f32 weights promotes it). On a CUDA tensor
    ``index_add_`` adds with atomics, so the order of the sum (and its last
    bits) varies by run. On the CPU both directions are bit-reproducible:
    the gather is an ``index_select``, whose backward is an ``index_add_``
    (advanced indexing's backward accumulates in a varying order there).
    Sharded with the overlap split, the own-block edges read x itself and
    the others the gathered features."""
    out = _segment_sum(graph.n_node, graph.row, graph.col, graph.weight,
                       gather_global(graph, x))
    if graph.loc_row is None:
        return out
    return out + _segment_sum(graph.n_node, graph.loc_row, graph.loc_col,
                              graph.loc_weight, x)


def spmm_ring(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Sharded SpMM over a ring instead of an all-gather
    (``glass_tpu/ops/spmm.py::spmm_ring``): the own-block edges from x, then
    K - 1 ring steps, each shifting the block in hand one rank down (rank r
    then holds block (r + s + 1) % K at step s) and adding ring bucket s
    from it. Each step is one ``dist.batch_isend_irecv``; the backward runs
    the ring the other way. Needs the ring buckets and the own-block split
    (``partition_graph(ring=True)``)."""
    if graph.ring_row is None or graph.loc_row is None:
        raise ValueError("spmm mode 'ring' needs the ring buckets and the "
                         "own-block split: partition_graph(..., ring=True)")
    out = _segment_sum(graph.n_node, graph.loc_row, graph.loc_col,
                       graph.loc_weight, x)
    buf = x
    for s in range(graph.ring_row.shape[0]):
        buf = ring_shift(buf, graph.axis)
        out = out + _segment_sum(graph.n_node, graph.ring_row[s],
                                 graph.ring_col[s], graph.ring_weight[s], buf)
    return out


def _block_sparse(graph: Graph, x: torch.Tensor, mode: str) -> torch.Tensor:
    """The band, BCSR, hybrid or sparse-block product of x with the graph's
    layouts."""
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
    if graph.sblock is not None:
        return sblock_spmm(graph.sblock, x, graph.sblock_t)
    if graph.bcsr is None:
        raise ValueError(
            "spmm mode 'pallas' needs a block-sparse layout: build the "
            "graph with materialize_bcsr=True")
    return bcsr_spmm(graph.bcsr, x, graph.bcsr_t)


def spmm(graph: Graph, x: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
    """Computes ``A @ x`` with the normalized adjacency held by ``graph``.

    Args:
      graph: a :class:`Graph` (one block of a sharded graph, see the module
        docstring).
      x: (n_node, F) node features.
      mode: "dense" | "segment" | "ring" | "band" | "hybrid" | "pallas" |
        None (dense if the graph holds a dense adjacency or the int8 dense
        layout, else segment; segment is the ring on a graph with ring
        buckets).
    """
    if mode is None:
        has_dense = graph.dense is not None or graph.dense_q is not None
        mode = "dense" if has_dense else "segment"
    if mode == "segment" and graph.ring_row is not None:
        mode = "ring"
    if mode == "pallas":
        if graph.band is not None:
            mode = "hybrid" if graph.bcsr is not None else "band"
        elif graph.bcsr is None and graph.sblock is None and \
                graph.plan in ("dense", "segment"):
            mode = graph.plan  # the planner declined every kernel layout
    if mode == "dense":
        return spmm_dense(graph, x)
    if mode == "segment":
        return spmm_segment(graph, x)
    if mode == "ring":
        return spmm_ring(graph, x)
    if mode in ("hybrid", "band", "pallas"):
        return _block_sparse(graph, gather_global(graph, x), mode)
    raise ValueError(f"unknown spmm mode {mode!r}")

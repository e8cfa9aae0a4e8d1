"""The work a cell needs, counted from the generated graph and the model's
shapes, never from the program's layout: a later change that stores the
adjacency differently leaves these numbers where they are.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, at the full
700 W power limit); PERF.md gives the card's power limit beside each reading.
"""

from __future__ import annotations

import numpy as np

PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}
X_ITEMSIZE = 4  # the model's activations are f32


def distinct_nnz(edge_index: np.ndarray, n: int) -> int:
    """The adjacency's nonzeros: distinct (row, col) pairs of the directed
    edge list (a repeated edge is one entry of A, whose weight counts it
    twice)."""
    key = edge_index[0].astype(np.int64) * n + edge_index[1]
    return int(np.unique(key).size)


def spmm_bytes(nnz: int, n: int, h: int, adj_itemsize: int) -> int:
    """Bytes one ``A @ x`` needs: each nonzero's value and int32 column,
    the int32 row offsets, x read once and the output written once."""
    return (nnz * (adj_itemsize + 4) + (n + 1) * 4
            + 2 * n * h * X_ITEMSIZE)


def spmm_flops(nnz: int, h: int) -> int:
    return 2 * nnz * h


def spmm_bound_s(nnz: int, n: int, h: int, adj_itemsize: int,
                 peak_flops: float = PEAK_F32_FLOPS) -> float:
    """The least time one ``A @ x`` could take: the larger of its bytes over
    the memory's rate and its operations over the peak."""
    return max(spmm_bytes(nnz, n, h, adj_itemsize) / PEAK_HBM_BYTES_PER_S,
               spmm_flops(nnz, h) / peak_flops)


def linear_flops(n: int, model: dict) -> int:
    """The conv layers' Linears over all n nodes: two z-mixed ``trans``
    (H -> H) and two ``comb`` (2H -> H) a layer."""
    h = model["hidden_dim"]
    return model["conv_layer"] * (2 * 2 * n * h * h + 2 * 2 * n * 2 * h * h)


def head_flops(batch: int, model: dict, out_channels: int) -> int:
    emb = model["hidden_dim"] * (model["conv_layer"] if model["jk"] else 1)
    return 2 * batch * emb * out_channels


def pool_flops(pooled_nodes: int, model: dict) -> int:
    emb = model["hidden_dim"] * (model["conv_layer"] if model["jk"] else 1)
    return pooled_nodes * emb


def forward_flops(n: int, nnz: int, model: dict, out_channels: int,
                  batch: int, pooled_nodes: int) -> int:
    """One forward: the Linears, one SpMM a layer, the pool and the
    head."""
    return (linear_flops(n, model)
            + model["conv_layer"] * spmm_flops(nnz, model["hidden_dim"])
            + pool_flops(pooled_nodes, model)
            + head_flops(batch, model, out_channels))


def train_step_flops(n: int, nnz: int, model: dict, out_channels: int,
                     batch: int, pooled_nodes: int) -> int:
    """One training step: the forward, then a backward of twice the
    forward's Linears and head, one transposed SpMM a layer and the pool's
    scatter once more."""
    return (forward_flops(n, nnz, model, out_channels, batch, pooled_nodes)
            + 2 * linear_flops(n, model)
            + 2 * head_flops(batch, model, out_channels)
            + model["conv_layer"] * spmm_flops(nnz, model["hidden_dim"])
            + pool_flops(pooled_nodes, model))

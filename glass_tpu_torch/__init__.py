"""glass_tpu_torch — the PyTorch/CUDA port of glass_tpu for one NVIDIA H100.

The JAX package ``glass_tpu`` stays the reference; this package keeps its
module names and is held against it by the ``tests/test_torch_*.py`` parity
tests. Every layer's ``A @ x`` in the "pallas" and "band" SpMM modes runs a
hand-written CUDA kernel (``csrc/bcsr_spmm.cu`` for chunked BCSR,
``csrc/band_spmm.cu`` for banded slabs and the int8 dense layout), forward
and backward, at f32, bf16 or int8 adjacencies (``build_graph(...,
dense_dtype=...)``), built with ``nvcc`` at first use. ``Trainer`` trains
GLASS, in f32 or with bf16 activations (``GLASS(...,
compute_dtype="bfloat16")``), and ``Predictor`` serves it. With
``GLASS_TPU_FUSED_NORM=1`` every GraphNorm runs the fused passes of
``csrc/graph_norm.cu``. ``python -m glass_tpu_torch.cli.glass_test`` runs
the experiment protocol (``train/protocol.py``) end to end. Entry points
compute on "cuda" unless the caller passes ``device="cpu"`` (the CLI:
``--device -1``).
"""

from glass_tpu_torch.nn.modules import GLASS
from glass_tpu_torch.ops.band_spmm import BandedAdj, band_spmm, build_band
from glass_tpu_torch.ops.dense_q import DenseQ, build_dense_q, dense_q_spmm
from glass_tpu_torch.ops.graph import Graph, build_graph
from glass_tpu_torch.ops.spmm import spmm
from glass_tpu_torch.serve import Predictor
from glass_tpu_torch.train.loop import (
    TrainConfig,
    Trainer,
    make_eval_batches,
    make_train_batches,
)
from glass_tpu_torch.utils.checkpoint import params_from_flax

__all__ = ["BandedAdj", "DenseQ", "GLASS", "Graph", "Predictor",
           "TrainConfig", "Trainer", "band_spmm", "build_band",
           "build_dense_q", "build_graph", "dense_q_spmm",
           "make_eval_batches", "make_train_batches", "params_from_flax",
           "spmm"]

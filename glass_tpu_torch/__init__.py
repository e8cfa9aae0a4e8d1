"""glass_tpu_torch — the PyTorch/CUDA port of glass_tpu for one NVIDIA H100.

The JAX package ``glass_tpu`` stays the reference; this package keeps its
module names and is held against it by the ``tests/test_torch_*.py`` parity
tests. Every layer's ``A @ x`` in the "pallas" and "band" SpMM modes runs a
hand-written CUDA kernel (``csrc/bcsr_spmm.cu`` for chunked BCSR,
``csrc/band_spmm.cu`` for banded slabs), forward and backward, built with
``nvcc`` at first use. ``Trainer`` trains GLASS and ``Predictor`` serves it.
Entry points compute on "cuda" unless the caller passes ``device="cpu"``.
"""

from glass_tpu_torch.nn.modules import GLASS
from glass_tpu_torch.ops.band_spmm import BandedAdj, band_spmm, build_band
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

__all__ = ["BandedAdj", "GLASS", "Graph", "Predictor", "TrainConfig",
           "Trainer", "band_spmm", "build_band", "build_graph",
           "make_eval_batches", "make_train_batches", "params_from_flax",
           "spmm"]

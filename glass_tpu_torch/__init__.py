"""glass_tpu_torch — the PyTorch/CUDA port of glass_tpu for one NVIDIA H100.

The JAX package ``glass_tpu`` stays the reference; this package keeps its
module names and is held against it by the ``tests/test_torch_*.py`` parity
tests. Every layer's ``A @ x`` in the "pallas" SpMM mode runs a hand-written
CUDA kernel (``csrc/bcsr_spmm.cu``), built with ``nvcc`` at first use.
Entry points compute on "cuda" unless the caller passes ``device="cpu"``.
"""

from glass_tpu_torch.nn.modules import GLASS
from glass_tpu_torch.ops.graph import Graph, build_graph
from glass_tpu_torch.ops.spmm import spmm
from glass_tpu_torch.serve import Predictor
from glass_tpu_torch.utils.checkpoint import params_from_flax

__all__ = ["GLASS", "Graph", "Predictor", "build_graph", "params_from_flax", "spmm"]

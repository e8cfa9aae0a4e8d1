"""spmm_roofline.train: the least time the window's SpMMs need (one
``A @ x`` and one ``A^T @ g`` a conv layer and step, each bounded by the
generated graph's nonzeros, ``yardstick.spmm_bound_s``) over the device
time of the SpMM kernels, in %. Layer: kernels. The kernels are those
whose names match PATTERNS; where none ran (another path carries the
product) the metric is left out, and ``mfu.train`` still bounds the
step."""

import re

from benchmark.yardstick import spmm_bound_s

PATTERNS = [re.compile(p) for p in (
    r"bcsr_tf32_kernel", r"band_tf32_kernel", r"spmm_kernel[<I]",
    r"dense_q_kernel")]


def read(run):
    from benchmark.trace import kernel_seconds

    if run.mode != "train" or run.device_trace is None:
        return None
    spent = kernel_seconds(run.trace["kernels"], PATTERNS)
    if not spent:
        return None
    calls = 2 * run.model["conv_layer"] * run.stats["steps"]
    bound = spmm_bound_s(run.nnz, run.n, run.model["hidden_dim"],
                         run.adj_itemsize)
    return calls * bound / spent * 100

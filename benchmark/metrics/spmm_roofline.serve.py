"""spmm_roofline.serve: the least time the window's SpMMs need (one
``A @ x`` a conv layer and request, bounded by the generated graph's
nonzeros, ``yardstick.spmm_bound_s``) over the device time of the SpMM
kernels, in %. Layer: kernels. The kernels are those whose names match
PATTERNS; where none ran the metric is left out, and ``mfu.serve`` still
bounds the forward."""

import re

from benchmark.yardstick import spmm_bound_s

PATTERNS = [re.compile(p) for p in (
    r"bcsr_tf32_kernel", r"band_tf32_kernel", r"spmm_kernel[<I]",
    r"dense_q_kernel")]


def read(run):
    from benchmark.trace import kernel_seconds

    if run.mode != "serve" or run.device_trace is None:
        return None
    spent = kernel_seconds(run.trace["kernels"], PATTERNS)
    if not spent:
        return None
    calls = run.model["conv_layer"] * run.stats["requests"]
    bound = spmm_bound_s(run.nnz, run.n, run.model["hidden_dim"],
                         run.adj_itemsize)
    return calls * bound / spent * 100

"""pool_bwd_us.train: the device us a step of the pool's gather backward
(``ops/segment.py::pool_subgraphs``, the backward of ``emb[index]``):
the device time of the kernels that PATTERNS name in the traced window,
over the steps that the program's counter ``train.pool_slots`` counted
there (one add a step, ``glass_tpu_torch.utils.profiling.span_table``).
Layer: model.

The kernel sorts the gathered indices and sums each index's slots one
after another, so its time follows the longest run of one index, not the
bytes. Left out where the counter or the kernel is absent: a program
without the counter, or another path carrying the backward."""

import re

PATTERNS = [re.compile(r"indexing_backward_kernel")]


def read(run):
    from glass_tpu_torch.utils import profiling

    from benchmark.trace import kernel_seconds

    if run.mode != "train" or run.device_trace is None:
        return None
    slots = getattr(profiling, "span_table", dict)().get("train.pool_slots")
    spent = kernel_seconds(run.trace["kernels"], PATTERNS)
    if not slots or not slots["count"] or not spent:
        return None
    return spent / slots["count"] * 1e6

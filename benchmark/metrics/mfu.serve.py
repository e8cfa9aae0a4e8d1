"""mfu.serve: the model FLOPs of the traced window's requests (a forward
each, ``yardstick.forward_flops``, at the generated graph's nonzeros)
over the window's length and the f32 peak, in %. Layer: model (the whole
forward)."""

from benchmark.yardstick import (PEAK_F32_FLOPS, forward_flops, head_flops,
                                 pool_flops)


def read(run):
    t = run.device_trace
    if run.mode != "serve" or t is None:
        return None
    s, m = run.stats, run.model
    per_graph = forward_flops(run.n, run.nnz, m, run.cell.out_channels, 0, 0)
    flops = (s["requests"] * per_graph + pool_flops(s["pooled_nodes"], m)
             + head_flops(s["subgraphs"], m, run.cell.out_channels))
    return flops / t["window_s"] / PEAK_F32_FLOPS * 100

"""mfu.train: the model FLOPs of the traced window's training steps
(``yardstick.train_step_flops``: the GLASS equations at the generated
graph's nonzeros) over the window's length and the f32 peak, in %.
Layer: model (the whole step)."""

from benchmark.yardstick import PEAK_F32_FLOPS, train_step_flops


def read(run):
    t = run.device_trace
    if run.mode != "train" or t is None:
        return None
    s = run.stats
    batch = s["subgraphs"] // s["steps"]
    flops = s["steps"] * train_step_flops(
        run.n, run.nnz, run.model, run.cell.out_channels, batch,
        s["pooled_nodes"] // s["steps"])
    return flops / t["window_s"] / PEAK_F32_FLOPS * 100

"""step_device_ms.train: the card's busy time (the union of its kernels,
copies and sets in the traced window) a training step. Layer: training
loop."""


def read(run):
    t = run.device_trace
    if run.mode != "train" or t is None:
        return None
    return t["busy_s"] / run.stats["steps"] * 1e3

"""idle_share.serve: the share of the traced window in which the card ran
nothing, 1 - busy / window. Layer: device."""


def read(run):
    t = run.device_trace
    if run.mode != "serve" or t is None:
        return None
    return (1 - t["busy_s"] / t["window_s"]) * 100

"""request_device_ms.serve: the card's busy time in the traced window a
request. Layer: serving."""


def read(run):
    t = run.device_trace
    if run.mode != "serve" or t is None:
        return None
    return t["busy_s"] / run.stats["requests"] * 1e3

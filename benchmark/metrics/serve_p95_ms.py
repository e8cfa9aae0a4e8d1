"""serve_p95_ms: the 95th percentile of every request's latency in the
window, from the call into ``Predictor`` to its logits on the host."""

import numpy as np


def read(run):
    if run.mode != "serve":
        return None
    return float(np.percentile(run.stats["latencies"], 95)) * 1e3

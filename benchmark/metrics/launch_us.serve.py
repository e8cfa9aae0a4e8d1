"""launch_us.serve: the self time of the program's ``glass.serve.launch``
span (the copy into the captured program's static buffers and the
replay's enqueue; a capture is a child span, left out) a request, in us,
from the span table of the traced window
(``glass_tpu_torch.utils.profiling.span_table``). Layer: serving.

It reads the launch as traced: the profiler's device tracing (CUPTI)
makes ``cudaGraphLaunch`` 2.2-3.8x slower than untraced on an H100
host, and a slower launch overlaps more of the forward, so that
``readback_us.serve`` falls as this rises. The sum of the two is the
stable number; the untraced launch cost is not read here.

Read only where the card ran the window: on the CPU the spans time other
work. A program without the table or the span gives nothing."""


def read(run):
    from glass_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()
    part = table.get("glass.serve.launch")
    whole = table.get("glass.serve.request")
    if run.device_trace is None or not part or not whole:
        return None
    return part["self_s"] / whole["count"] * 1e6

"""readback_us.serve: the time of the program's ``glass.serve.readback``
span (the logits to the host, with the host's wait for the card) a
request, in us, from the span table of the traced window
(``glass_tpu_torch.utils.profiling.span_table``). Layer: serving.

Most of it is the wait for the forward to finish on the card, so it
holds whatever of the forward the launch before it did not overlap:
under the profiler's device tracing the launch slows and this falls
(``launch_us.serve``). The sum of the two is the stable number.

Read only where the card ran the window: on the CPU the spans time other
work. A program without the table or the span gives nothing."""


def read(run):
    from glass_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()
    part = table.get("glass.serve.readback")
    whole = table.get("glass.serve.request")
    if run.device_trace is None or not part or not whole:
        return None
    return part["total_s"] / whole["count"] * 1e6

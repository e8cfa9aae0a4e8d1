"""stage_us.serve: the self time of the program's ``glass.serve.stage``
span (``Predictor`` picking the bucket and filling the pinned ``pos``) a
request, in us, from the span table of the traced window
(``glass_tpu_torch.utils.profiling.span_table``). Layer: serving. Read
only where the card ran the window: on the CPU the spans time other work.
A program without the table or the span gives nothing."""


def read(run):
    from glass_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()
    part = table.get("glass.serve.stage")
    whole = table.get("glass.serve.request")
    if run.device_trace is None or not part or not whole:
        return None
    return part["self_s"] / whole["count"] * 1e6

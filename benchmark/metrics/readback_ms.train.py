"""readback_ms.train: the time of the program's ``glass.train.readback``
span (the epoch's mean loss and step losses to the host, with the host's
wait for the card) an epoch, in ms, from the span table of the traced
window (``glass_tpu_torch.utils.profiling.span_table``). Layer: training
loop. Read only where the card ran the window: on the CPU the spans time
other work. A program without the table or the span gives nothing."""


def read(run):
    from glass_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()
    part = table.get("glass.train.readback")
    whole = table.get("glass.train.epoch")
    if run.device_trace is None or not part or not whole:
        return None
    return part["total_s"] / whole["count"] * 1e3

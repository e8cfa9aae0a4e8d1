"""launch_us.train: the self time of the program's ``glass.train.step``
span (the copy into the captured step's static buffers, the replay's
enqueue and the loss's store; a capture is a child span, left out) a
step, in us, from the span table of the traced window
(``glass_tpu_torch.utils.profiling.span_table``). Layer: training loop.

What it reads is the queue's back-pressure, not the enqueue's host cost:
the host runs ahead of the card until about 21 captured steps are
queued, and from then on each ``cudaGraphLaunch`` waits for a step to
end. So it tracks the step's device time (``step_device_ms.train``),
and it falls below that only where the host, not the card, sets the
pace.

Read only where the card ran the window: on the CPU the step runs on the
host. A program without the table or the span gives nothing."""


def read(run):
    from glass_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()
    step = table.get("glass.train.step")
    if run.device_trace is None or not step:
        return None
    return step["self_s"] / step["count"] * 1e6

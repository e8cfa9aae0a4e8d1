"""bucket_fill.serve: the share of the buckets' node slots that the
traced window's requests filled, the program's counters ``serve.nodes``
(real nodes) over ``serve.slots`` (b x w of each request's bucket), in %
(``glass_tpu_torch.utils.profiling.span_table``). Layer: serving. Read
only where the card ran the window, as the serving spans are. A program
without the table or the counters gives nothing."""


def read(run):
    from glass_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()
    nodes, slots = table.get("serve.nodes"), table.get("serve.slots")
    if run.device_trace is None or not nodes or not slots:
        return None
    return nodes["value"] / slots["value"] * 100

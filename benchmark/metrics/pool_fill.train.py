"""pool_fill.train: the share of the pool's (B, L) slots that the traced
window's training steps filled with a node, the program's counters
``train.pool_nodes`` (real nodes) over ``train.pool_slots`` (B x L a
step), in % (``glass_tpu_torch.utils.profiling.span_table``). Layer:
model. A property of the traffic: the rest is padding, which the pool
gathers and masks. Read only where the card ran the window. A program
without the table or the counters gives nothing."""


def read(run):
    from glass_tpu_torch.utils import profiling

    table = getattr(profiling, "span_table", dict)()
    nodes, slots = table.get("train.pool_nodes"), table.get("train.pool_slots")
    if run.device_trace is None or not nodes or not slots:
        return None
    return nodes["value"] / slots["value"] * 100

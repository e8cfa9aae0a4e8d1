"""graph_build_s: the benchmark's span around ``build_graph`` in set-up
(the native CSR and normalization, the layout planner and the layout's
fill, copied to the card). Layer: layout build."""


def read(run):
    return run.cell.spans.get("graph_build_s")

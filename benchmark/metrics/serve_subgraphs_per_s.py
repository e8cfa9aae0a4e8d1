"""serve_subgraphs_per_s: every subgraph predicted over the window's whole
time."""


def read(run):
    if run.mode != "serve":
        return None
    return run.stats["subgraphs"] / run.stats["seconds"]

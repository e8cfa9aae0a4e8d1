"""train_subgraphs_per_s: every subgraph stepped over the window's whole
time, through whole ``Trainer.train_epoch`` calls."""


def read(run):
    if run.mode != "train":
        return None
    return run.stats["subgraphs"] / run.stats["seconds"]

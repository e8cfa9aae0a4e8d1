"""GLASS in plain PyTorch with mean aggregation besides gcn: the equations
of ``glass.py`` (two or more conv layers, jumping knowledge, the dropout
sites, the losses, Adam), over an adjacency that may be row-normalized.

The mean adjacency (GLASS's ``buildAdj``, ``impl/models.py:83-111``,
whose mean branch is at ``:95-99``; SURVEY.md §2):

  A = D^-1 W       weight[e] = 1 / d[row]

with ``d`` the row's edge count (repeated edges count each time) and a
row with none counted as 1. Unlike gcn's D^-1/2 W D^-1/2 it is not
symmetric where degrees differ, so ``A^T g`` in the backward (``glass.py``'s
edge sum over the transposed list, the same weights) differs from
``A g``. ``gcn`` is ``glass.py``'s own; any other ``aggr`` raises
``NotImplementedError``. Every other name the drivers call
(``reference/__init__.py``) is ``glass.py``'s.
"""

from __future__ import annotations

import torch

from benchmark.reference import glass
from benchmark.reference.glass import (BETAS, norm, param_shapes,  # noqa: F401
                                       precision, predict, train_steps)


class Adjacency(glass.Adjacency):
    """The normalized adjacency of a directed edge list, from the edges
    alone: ``mean`` (``weight[e] = 1 / d[row]``) or ``gcn`` (as
    ``glass.Adjacency``)."""

    def __init__(self, edge_index: torch.Tensor, n: int, aggr: str = "gcn"):
        if aggr not in ("gcn", "mean"):
            raise NotImplementedError(
                f"the reference has gcn and mean only, not {aggr}")
        super().__init__(edge_index, n, "gcn")
        if aggr == "mean":
            deg = torch.bincount(self.row, minlength=n).double()
            deg[deg < 0.5] += 1.0
            self.weight = (1.0 / deg[self.row]).float()

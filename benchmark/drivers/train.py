"""A closed loop of ``Trainer.train_epoch`` calls over the configuration's
train split, reshuffled every epoch with ``make_train_batches``
(drop_last), as a user's training run makes them.

Set-up builds the graph with the layout planner's choice, loads the
benchmark's initial weights, and drives the first ``check_steps`` steps
through ``train_epoch`` (one step, then the rest), reading the first
gradient from Adam's state in between; one full epoch then warms the
window's shapes. The same trainer goes on into the window. The check
holds those first steps against the reference's from the same weights,
batches and dropout seed.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from glass_tpu_torch import TrainConfig, Trainer, make_train_batches

from benchmark import cells
from benchmark import generate as gen
from benchmark import trace as tr
from benchmark.compare import train_numbers


class Driver(cells.Cell):
    mode = "train"

    def setup(self, seed: int) -> None:
        self.make_inputs(seed)
        self.pos, self.y = gen.train_split(self.cfg["subgraphs"],
                                           self.cfg["graph"], seed,
                                           self.bench)
        graph, x, model = self.build_model()
        m = self.model_cfg
        trainer = Trainer(model, graph, x, TrainConfig(
            lr=m["lr"], resi=m["resi"], batch_size=m["batch_size"],
            loss=m["loss"], use_z=m["use_maxzeroone"]))
        self.dropout_seed = gen.sub_seed(seed, gen.DROPOUT)
        trainer.init(self.dropout_seed)
        self.shuffle = gen.rng_for(seed, gen.SHUFFLE)
        self.program = trainer
        pos_b, y_b = make_train_batches(self.shuffle, self.pos, self.y,
                                        m["batch_size"])
        k = self.traffic["check_steps"]
        self.first = (pos_b[:k], y_b[:k])
        named = dict(model.named_parameters())
        p0 = {n: p.detach().clone() for n, p in named.items()}
        first = trainer.train_epoch(pos_b[:1], y_b[:1])
        # Adam's first moment after one step is (1 - beta1) g; a leaf it
        # holds no state of got no gradient
        state = trainer.optimizer.state
        b1 = self.ref.BETAS[0]
        grad_norms = {n: self.ref.norm(state[p]["exp_avg"]) / (1 - b1)
                      if "exp_avg" in state.get(p, {}) else 0.0
                      for n, p in named.items()}
        rest = trainer.train_epoch(pos_b[1:k], y_b[1:k])
        self.prog_record = dict(
            losses=[float(v) for v in first.step_losses]
            + [float(v) for v in rest.step_losses],
            grad_norms=grad_norms,
            change_norms={n: self.ref.norm(p.detach() - p0[n])
                          for n, p in named.items()})
        del p0
        self.mark("check_steps")
        trainer.train_epoch(pos_b, y_b)  # the window's shapes, warm
        cells.sync(self.device)
        self.mark("warm")

    def window(self, seconds: float) -> dict:
        """Whole epochs until ``seconds`` have passed; each ends in the
        epoch's loss readback."""
        bs = self.model_cfg["batch_size"]
        steps = subgraphs = nodes = bad = 0
        t0 = time.perf_counter()
        with tr.span("window"):
            while True:
                with tr.span("shuffle"):
                    pos_b, y_b = make_train_batches(self.shuffle, self.pos,
                                                    self.y, bs)
                with tr.span("train_epoch"):
                    res = self.program.train_epoch(pos_b, y_b)
                steps += len(res.step_losses)
                subgraphs += pos_b.shape[0] * pos_b.shape[1]
                nodes += int((pos_b >= 0).sum())
                bad += int((~np.isfinite(res.step_losses)).sum())
                if time.perf_counter() - t0 >= seconds:
                    break
            cells.sync(self.device)
        return dict(seconds=time.perf_counter() - t0, attempted=steps,
                    failed=bad, steps=steps, subgraphs=subgraphs,
                    pooled_nodes=nodes)

    def reference_record(self, tf32: bool = False,
                         half_batch: bool = False) -> dict:
        """The reference's first steps from the same weights, batches and
        dropout seed (``tf32``: the control; ``half_batch``: a fault)."""
        adj = self.reference_adjacency()
        ids = torch.from_numpy(self.ids).to(self.device)
        pos_b, y_b = self.first
        batches = [(torch.from_numpy(p).to(self.device),
                    torch.from_numpy(np.asarray(y)).to(self.device))
                   for p, y in zip(pos_b, y_b)]
        with self.ref.precision(tf32):
            out = self.ref.train_steps(self.weights, self.model_cfg, adj,
                                       ids, batches, self.dropout_seed,
                                       half_batch=half_batch)
        return dict(losses=out["losses"],
                    grad_norms={k: self.ref.norm(g)
                                for k, g in out["first_grad"].items()},
                    change_norms={k: self.ref.norm(v - self.weights[k])
                                  for k, v in out["params"].items()})

    def numbers(self, tf32: bool = False) -> Dict[str, float]:
        return train_numbers(self.prog_record, self.reference_record(tf32))

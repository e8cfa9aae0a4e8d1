"""The plain reference against the program (``glass_tpu_torch``) on the
CPU at a small size, on the benchmark's seeded weights: the forward's
logits, and training steps with the same dropout masks. Only this test
imports both; the reference imports nothing of the program."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells
from benchmark import generate as gen
from benchmark.compare import train_numbers
from benchmark.reference import glass as ref
from benchmark.tests import tiny

SEED = 2**31 + 29


def small(name):
    cfg = json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())
    return tiny.tiny_config(cfg)


@pytest.mark.parametrize("name", ["em_user", "hpo_metab"])
def test_forward_logits(name):
    cfg = small(name)
    cell = cells.driver("serve")(cfg, {}, torch.device("cpu"))
    cell.make_inputs(SEED)
    graph, x, model = cell.build_model()
    rng = gen.rng_for(SEED, 99)
    pos = gen.pad(cell.draw_subgraphs(rng, 9))
    from glass_tpu_torch.ops.labeling import max_zero_one

    pos_t = torch.from_numpy(pos)
    with torch.no_grad():
        got = model(graph, x, pos_t, max_zero_one(pos_t, graph.n_node))
    want = ref.predict(cell.weights, cfg["model"], cell.reference_adjacency(),
                       torch.from_numpy(cell.ids), pos_t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["em_user", "hpo_metab"])
def test_training_steps(name):
    cfg = small(name)
    cell = cells.driver("train")(cfg, {"check_steps": 3}, torch.device("cpu"))
    cell.setup(SEED)
    numbers = cell.numbers()
    assert numbers["loss"] < 1e-5
    assert numbers["grad"] < 1e-4 and numbers["change"] < 1e-4
    half = train_numbers(cell.reference_record(half_batch=True),
                               cell.reference_record())
    assert half["loss"] > 1e-3


def test_masks_follow_the_program_s_draws():
    """The reference draws the program's dropout masks from the same seed:
    with dropout on, one step's loss agrees."""
    cfg = small("em_user")
    assert cfg["model"]["dropout"] == 0.5
    cell = cells.driver("train")(cfg, {"check_steps": 1}, torch.device("cpu"))
    cell.setup(SEED)
    rec = cell.reference_record()
    assert abs(rec["losses"][0] - cell.prog_record["losses"][0]) < 1e-5

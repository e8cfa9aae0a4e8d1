"""The ppi_bp configuration's files: the degree-skewed graph recipe at the
published counts, the lognormal subgraph sizes at the published mean, the
cell correct at a tiny size on the CPU and failed by the half-batch fault,
and ``spmm_us.train`` silent where the program's counter is absent."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import byname
from benchmark import generate as gen
from benchmark.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
SEED = 2**31 + 2401
# SubGNN (Alsentzer et al., 2020), Table 1, PPI-BP
NODES, EDGES, SUBGRAPHS, MEAN_SIZE = 17_080, 316_951, 1_591, 10.2


def config():
    return json.loads((BENCH / "configs" / "ppi_bp.json").read_text())


def test_powerlaw_graph_at_published_size():
    cfg = config()
    ei, n = gen.make_graph(cfg["graph"], SEED)
    assert n == NODES and ei.shape == (2, 2 * EDGES)
    assert ei.min() >= 0 and ei.max() < n
    assert np.array_equal(ei[0, :EDGES], ei[1, EDGES:])
    assert np.unique(ei[0] * n + ei[1]).size == 2 * EDGES
    assert not (ei[0] == ei[1]).any()
    deg = np.bincount(ei[0], minlength=n)
    assert deg.max() >= 10 * deg.mean()
    again, _ = gen.make_graph(cfg["graph"], SEED)
    assert np.array_equal(ei, again)
    other, _ = gen.make_graph(cfg["graph"], SEED + 1)
    assert not np.array_equal(ei, other)


def test_powerlaw_graph_at_a_tiny_size():
    ei, n = gen.make_graph(tiny.tiny_config(config())["graph"], SEED)
    assert n == 300 and np.unique(ei[0] * n + ei[1]).size == 6000
    assert not (ei[0] == ei[1]).any()


def test_lognormal_sizes_at_the_published_mean():
    spec = config()["subgraphs"]
    recipe = byname.load(BENCH / "subgraphs", "lognormal")
    assert recipe.params(10.2, 10.5) == pytest.approx((1.961, 0.850),
                                                      abs=1e-3)
    sizes = recipe.sizes(gen.rng_for(SEED, gen.SUBGRAPHS), SUBGRAPHS, spec)
    assert abs(sizes.mean() - MEAN_SIZE) <= 0.1 * MEAN_SIZE
    assert sizes.min() >= 2 and sizes.max() <= 128
    subs = recipe.draw(gen.rng_for(SEED, gen.SUBGRAPHS), 50, spec,
                       config()["graph"])
    assert all(len(set(s)) == len(s) and s.max() < NODES for s in subs)


def test_lognormal_sizes_alike_for_every_seed():
    """Every seed deals out the same sizes, in its own order, so the train
    split's padded width and node count do not move with the seed."""
    spec, graph = config()["subgraphs"], config()["graph"]
    recipe = byname.load(BENCH / "subgraphs", "lognormal")
    a = recipe.sizes(gen.rng_for(SEED, gen.SUBGRAPHS), SUBGRAPHS, spec)
    b = recipe.sizes(gen.rng_for(SEED + 1, gen.SUBGRAPHS), SUBGRAPHS, spec)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert not np.array_equal(a, b)
    assert b.max() == 128 and abs(b.std() - 10.5) <= 0.05 * 10.5
    widths = {gen.train_split(spec, graph, s)[0].shape[1]
              for s in (SEED, SEED + 1, SEED + 2)}
    assert widths == {123}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_tiny_cell_is_correct(root):
    out = tiny.run(root, "ppi_bp.train")
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"train_subgraphs_per_s", "setup_s"}


def test_fault_half_the_batch(root, monkeypatch):
    from glass_tpu_torch.train import loop

    for name, fn in list(loop.LOSSES.items()):
        monkeypatch.setitem(
            loop.LOSSES, name,
            lambda logits, y, fn=fn: fn(logits[: len(y) // 2],
                                        y[: len(y) // 2]))
    assert tiny.run(root, "ppi_bp.train")["correct"] is False


def test_spmm_us_silent_without_the_counter(monkeypatch):
    from glass_tpu_torch.utils import profiling

    read = byname.load(BENCH / "metrics", "spmm_us.train").read
    trace = dict(busy_s=1.0, kernels={
        "void sblock_spmm_kernel<16>(float const*)": [8, 0.0016]})
    run = SimpleNamespace(mode="train", device_trace=trace, trace=trace)
    monkeypatch.setattr(profiling, "span_table", lambda: {})
    assert read(run) is None
    monkeypatch.setattr(profiling, "span_table", lambda: {
        "train.spmm": dict(count=2, value=8, parent="glass.train.step")})
    assert read(run) == pytest.approx(200.0)
    trace["kernels"] = {"other_kernel": [8, 0.0016]}
    assert read(run) is None
    monkeypatch.delattr(profiling, "span_table")
    assert read(SimpleNamespace(mode="train", device_trace=None)) is None

"""The copied generators: deterministic by seed, at the published node and
distinct edge counts, and the serving pool's fixed set of request
sizes."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import byname
from benchmark import generate as gen

BENCH = Path(__file__).resolve().parents[1]
SEED = 2**31 + 11
# SubGNN (Alsentzer et al., 2020), Table 1: nodes and undirected edges
PUBLISHED = {"em_user": (57_333, 4_573_417), "hpo_metab": (14_587, 3_238_174)}


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["em_user", "hpo_metab"])
def test_graph_at_published_size_and_deterministic(name):
    cfg = config(name)
    ei, n = gen.make_graph(cfg["graph"], SEED)
    nodes, e = PUBLISHED[name]
    assert n == nodes and ei.shape == (2, 2 * e)
    assert ei.min() >= 0 and ei.max() < n
    # each undirected edge both ways, none twice, no self-loop
    assert np.array_equal(ei[0, :e], ei[1, e:])
    assert np.array_equal(ei[1, :e], ei[0, e:])
    assert np.unique(ei[0] * n + ei[1]).size == 2 * e
    assert not (ei[0] == ei[1]).any()
    again, _ = gen.make_graph(cfg["graph"], SEED)
    assert np.array_equal(ei, again)
    other, _ = gen.make_graph(cfg["graph"], SEED + 1)
    assert not np.array_equal(ei, other)


def test_clustered_graph_keeps_to_neighbouring_communities():
    spec = dict(kind="clustered", nodes=150, community_size=16,
                undirected_edges=900, intra_frac=0.95)
    ei, n = gen.make_graph(spec, 3)
    gap = np.abs(ei[0] // 16 - ei[1] // 16)
    assert n == 150 and gap.max() == 1 and ei.max() == 149
    assert (gap == 0).sum() == 2 * int(0.95 * 900)


def test_distinct_slots_fill_a_crowded_universe():
    """185 of 190 slots: the draws repeat often, so it draws again until
    the count is met, and keeps each slot once."""
    rng = np.random.default_rng(5)
    s = gen.distinct_slots(rng, lambda m: rng.integers(0, 190, m), 185, 190)
    assert s.size == 185 and np.unique(s).size == 185
    assert (np.diff(s) > 0).all() and s.max() < 190
    again = np.random.default_rng(5)
    assert np.array_equal(s, gen.distinct_slots(
        again, lambda m: again.integers(0, 190, m), 185, 190))


def test_degree_ids_rank_the_degrees():
    ei = np.array([[0, 0, 1, 2, 2, 2], [1, 2, 0, 0, 1, 3]])
    assert gen.degree_ids(ei, 4).ravel().tolist() == [2, 1, 3, 0]


def test_ladder4x_is_em_user_at_four_times_the_counts():
    """The scale ladder's 4x rung: em_user's graph and subgraph counts
    times 4, every other key of the run as em_user's. (The 36.6M-edge draw
    itself is left to the card.)"""
    em, big = config("em_user"), config("ladder4x")
    assert big["graph"]["nodes"] == 4 * em["graph"]["nodes"]
    assert (big["graph"]["undirected_edges"]
            == 4 * em["graph"]["undirected_edges"])
    assert big["subgraphs"]["count"] == 4 * em["subgraphs"]["count"]
    for key in ("nodes", "undirected_edges"):
        big["graph"].pop(key), em["graph"].pop(key)
    big["subgraphs"].pop("count"), em["subgraphs"].pop("count")
    for key in ("name", "source", "assumed"):
        big.pop(key), em.pop(key)
    assert big == em


@pytest.mark.parametrize("name", ["em_user", "hpo_metab", "ladder4x"])
def test_subgraph_draws(name):
    cfg = config(name)
    sub = cfg["subgraphs"]
    pos, y = gen.train_split(sub, cfg["graph"], SEED)
    assert pos.shape[0] == int(sub["count"] * sub["train_share"])
    sizes = (pos >= 0).sum(1)
    assert sizes.min() >= sub["min_nodes"] and sizes.max() <= sub["max_nodes"]
    assert all(len(set(r[r >= 0])) == len(r[r >= 0]) for r in pos)
    assert sorted(set(np.asarray(y).tolist())) == list(range(sub["classes"]))
    again, _ = gen.train_split(sub, cfg["graph"], SEED)
    assert np.array_equal(pos, again)
    if sub["kind"] == "community":
        csz = cfg["graph"]["community_size"]
        spread = [np.ptp(r[r >= 0] // csz) for r in pos]
        assert max(spread) < sub["max_communities"]


def test_em_user_train_split_is_43_steps_of_6():
    cfg = config("em_user")
    pos, _ = gen.train_split(cfg["subgraphs"], cfg["graph"], SEED)
    assert pos.shape[0] == 259 and pos.shape[0] // 6 == 43


def test_weights_deterministic_and_shaped():
    shapes = {"a.weight": ((3, 4), "linear:4"), "a.bias": ((3,), "linear:4"),
              "e.weight": ((5, 4), "embedding"),
              "n.weight": ((4,), "norm_one"), "n.bias": ((4,), "norm_zero")}
    w = gen.make_weights(shapes, SEED, "cpu")
    again = gen.make_weights(shapes, SEED, "cpu")
    assert all(w[k].shape == s for k, (s, _) in shapes.items())
    assert all((w[k] == again[k]).all() for k in w)
    assert w["a.weight"].abs().max() <= 0.5
    assert (w["n.weight"] - 1).abs().max() < 1


def test_pool_sizes_are_one_set_for_every_seed():
    traffic = json.loads((BENCH / "traffic" / "serve.json").read_text())
    serve = byname.load(BENCH / "drivers", "serve")
    counts = serve.band_counts(traffic["bands"], traffic["pool"])
    assert counts.size == traffic["pool"]
    for lo, hi, share in traffic["bands"]:
        inside = ((counts >= lo) & (counts <= hi)).sum()
        assert abs(inside - share * traffic["pool"]) <= 1
    assert 16 < counts.mean() < 17.5

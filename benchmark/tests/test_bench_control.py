"""The control on a card, at a size a test run holds: the reference with
TF32 on, put in the program's place, fails the cell's limits (the
cell-size readings, three seeds or more, are in PERF.md; run them with
``benchmark/control.py``)."""

import pytest

from benchmark import cells
from benchmark.compare import judge, serve_numbers, train_numbers
from benchmark.tests import tiny

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def medium(cfg: dict) -> dict:
    """A tenth of the cell's graph at the published widths."""
    graph, subgraphs = cfg["graph"], cfg["subgraphs"]
    cfg = tiny.tiny_config(cfg)
    if cfg["graph"]["kind"] == "clustered":
        cfg["graph"].update(nodes=graph["nodes"] // 10, community_size=256,
                            undirected_edges=graph["undirected_edges"] // 10)
        cfg["subgraphs"].update({k: subgraphs[k] for k in (
            "count", "min_nodes", "max_nodes")})
    else:
        cfg["graph"].update(nodes=1459, undirected_edges=324_000)
        cfg["subgraphs"].update(count=2400)
        cfg["model"]["batch_size"] = 59
    return cfg


@pytest.mark.card
@pytest.mark.parametrize("cell", ["em_user.train", "hpo_metab.train",
                                  "em_user.serve", "hpo_metab.serve",
                                  "ladder4x.train"])
def test_control_fails(card, cell):
    import json

    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == cell)
    cfg = medium(json.loads((tiny.REPO / next(
        c["file"] for c in spec["configs"] if c["name"] == w["config"]))
        .read_text()))
    traffic = json.loads((tiny.BENCH / "traffic" /
                          f"{w['traffic']}.json").read_text())
    limits = json.loads((tiny.BENCH / "limits" / f"{cell}.json").read_text())
    for seed in SEEDS:
        c = cells.make_cell(cfg, traffic, card)
        c.setup(seed)
        if c.mode == "serve":
            c.window(0.5)
        c.after_window()
        c.free_program()
        if c.mode == "train":
            ref = c.reference_record()
            assert judge(train_numbers(c.prog_record, ref), limits)[0]
            control = train_numbers(c.reference_record(tf32=True), ref)
        else:
            ref = c.reference_logits(c.picked)
            assert judge(serve_numbers(c.prog_logits, ref), limits)[0]
            control = serve_numbers(c.reference_logits(c.picked, tf32=True),
                                    ref)
        assert not judge(control, limits)[0], control

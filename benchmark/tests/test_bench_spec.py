"""BENCHMARK.json against the benchmark's contract: keys, names, limits on
sizes, bounds and the run length, and a file for every configuration,
traffic mix, cell limit and metric it names, and a reference for every
configuration."""

import json
import re
from pathlib import Path

import pytest

from benchmark import byname, reference

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(map(line, SPEC["command"]))
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch") and (REPO / p).is_dir()
    seconds = SPEC["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51


def test_a_full_check_fits():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    entries = SPEC[section]
    assert entries and len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        extra = set(e) - KEYS[section]
        assert set(e) >= KEYS[section] and extra <= {"workloads"}
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert line(e[k])


def test_configs():
    for c in SPEC["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
        # the plain reference the cell is checked against: a file directly
        # under benchmark/reference/ that defines what the drivers call
        path = REPO / cfg["reference"]
        assert path.parent == REPO / "benchmark" / "reference"
        assert path.suffix == ".py" and path.is_file()
        mod = byname.load(path.parent, path.stem)
        assert [n for n in reference.NAMES if not hasattr(mod, n)] == []


def test_workloads():
    names = {c["name"] for c in SPEC["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"]) <= 24
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and line(w["why"])
        bench = REPO / "benchmark"
        traffic = json.loads((bench / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (bench / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (bench / "limits" / f"{w['name']}.json").is_file()
        cfg = json.loads((REPO / next(c["file"] for c in SPEC["configs"]
                                      if c["name"] == w["config"]))
                         .read_text())
        assert (bench / "graphs" / f"{cfg['graph']['kind']}.py").is_file()
        assert (bench / "subgraphs"
                / f"{cfg['subgraphs']['kind']}.py").is_file()


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (REPO / "benchmark" / "metrics"
                / f"{m['name']}.py").is_file()


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        per = [m for m in SPEC["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])
               and m["moves"] in e2e]
        assert per

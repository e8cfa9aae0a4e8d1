"""The harness on the CPU at tiny sizes: the result line's keys, files found
by name, the refusal without a card, and the check catching faults
planted in the timed path."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.tests import tiny

CELLS = ["em_user.train", "hpo_metab.train", "em_user.serve",
         "hpo_metab.serve", "ladder4x.train"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line(root, cell):
    out = tiny.run(root, cell)
    assert list(out) == KEYS + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    spec = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} and c["value"] <= c["limit"]
               for c in out["checks"].values())


@pytest.mark.parametrize("cell", ["em_user.train", "hpo_metab.serve"])
def test_traced_line(root, cell):
    out = tiny.run(root, cell, traced=True)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    assert {"busy_s", "window_s"} <= set(out["device"])
    # the CPU runs no device operation: only the host clock's is read
    assert set(out["metrics"]) == {"graph_build_s"}


def test_new_files_found_by_name(root, tmp_path):
    """A configuration with its own graph recipe, a traffic mix with its own
    driver, limits and a metric, added as files (and entries in
    BENCHMARK.json), run with no other edit; and a configuration whose
    equations glass.py lacks (mean aggregation), checked against the
    reference its file names."""
    new = tmp_path / "copy"
    shutil.copytree(root, new)
    bench = new / "benchmark"
    cfg = json.loads((bench / "configs" / "em_user.json").read_text())
    cfg["graph"].update(kind="clustered_b", intra_frac=0.9)
    (bench / "configs" / "em_user_b.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "graphs" / "clustered.py",
                bench / "graphs" / "clustered_b.py")
    traffic = json.loads((bench / "traffic" / "train.json").read_text())
    (bench / "traffic" / "train_b.json").write_text(
        json.dumps(dict(traffic, driver="train_b")))
    (bench / "drivers" / "train_b.py").write_text(
        (bench / "drivers" / "train.py").read_text()
        + "\n\nclass Driver(Driver):\n"
        "    def window(self, seconds):\n"
        "        return dict(super().window(seconds), probe=7)\n")
    shutil.copy(bench / "limits" / "em_user.train.json",
                bench / "limits" / "em_user_b.train_b.json")
    (bench / "metrics" / "probe_count.py").write_text(
        "def read(run):\n    return run.stats['probe']\n")
    spec = json.loads((new / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="em_user_b",
                                file="benchmark/configs/em_user_b.json"))
    spec["workloads"].append(dict(spec["workloads"][0],
                                  name="em_user_b.train_b",
                                  config="em_user_b", traffic="train_b"))
    spec["per_layer"].append(dict(spec["per_layer"][0], name="probe_count",
                                  workloads=["em_user_b.train_b"]))
    for m in spec["end_to_end"]:
        if "em_user.train" in m.get("workloads", []):
            m["workloads"].append("em_user_b.train_b")
    (new / "BENCHMARK.json").write_text(json.dumps(spec))
    out = tiny.run(new, "em_user_b.train_b", traced=True)
    assert out["metrics"]["probe_count"]["value"] == 7
    out = tiny.run(new, "em_user_b.train_b")
    assert "train_subgraphs_per_s" in out["metrics"]

    # a copy of glass.py whose Adjacency also has mean aggregation: each
    # edge weighted by 1 / its row's degree
    text = (bench / "reference" / "glass.py").read_text()
    mean = text.replace('if aggr != "gcn":',
                        'if aggr not in ("gcn", "mean"):').replace(
        "        self.weight = (dinv[self.row] * dinv[self.col]).float()\n",
        "        self.weight = (dinv[self.row] * dinv[self.col]).float()\n"
        '        if aggr == "mean":\n'
        "            self.weight = (1.0 / deg[self.row]).float()\n")
    assert mean.count('"mean"') == text.count('"mean"') + 2
    (bench / "reference" / "glass_mean.py").write_text(mean)
    cfg = json.loads((bench / "configs" / "em_user.json").read_text())
    cfg["model"]["aggr"] = "mean"
    for name, ref in (("mean_own", "glass_mean"), ("mean_glass", "glass")):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(dict(
            cfg, name=name, reference=f"benchmark/reference/{ref}.py")))
        shutil.copy(bench / "limits" / "em_user.train.json",
                    bench / "limits" / f"{name}.train.json")
        spec["configs"].append(dict(spec["configs"][0], name=name,
                                    file=f"benchmark/configs/{name}.json"))
        spec["workloads"].append(dict(spec["workloads"][0],
                                      name=f"{name}.train", config=name))
        for m in spec["end_to_end"]:
            if "em_user.train" in m.get("workloads", []):
                m["workloads"].append(f"{name}.train")
    (new / "BENCHMARK.json").write_text(json.dumps(spec))
    out = tiny.run(new, "mean_own.train")
    assert out["correct"] is True
    with pytest.raises(NotImplementedError, match="mean"):
        tiny.run(new, "mean_glass.train")
    # a reference outside benchmark/reference/ is refused
    from benchmark import cells

    with pytest.raises(ValueError, match="benchmark/reference/"):
        cells.reference(dict(cfg, reference="benchmark/cells.py"), bench)


def test_run_refuses_without_a_card():
    res = subprocess.run(
        [sys.executable, str(tiny.BENCH / "run.py"), "--workload",
         "em_user.train", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA card" in res.stderr


def test_run_measures_only_the_checkout_s_program(tmp_path):
    """run.py in a checkout of only BENCHMARK.json and the benchmark's
    folder refuses, before anything else, whatever glass_tpu_torch the
    interpreter could find elsewhere."""
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "em_user.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(tiny.REPO)})
    assert res.returncode != 0 and res.stdout == ""
    assert "glass_tpu_torch is not in this checkout" in res.stderr


def test_run_without_the_program_prints_nothing(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; sys.path.insert(0, '.');"
         "from benchmark.tests import tiny;"
         "tiny.run(tiny.make_root(__import__('pathlib').Path('t')),"
         " 'em_user.train')"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert res.returncode != 0 and res.stdout == ""
    assert "glass_tpu_torch" in res.stderr


# ---------------------------------------------------------------- faults


def test_fault_state_unchanged(root, monkeypatch):
    """The optimizer's step leaves the parameters as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = tiny.run(root, "em_user.train")
    assert out["correct"] is False
    assert out["checks"]["change"]["value"] > out["checks"]["change"]["limit"]


@pytest.mark.parametrize("cell", ["em_user.train", "hpo_metab.train",
                                  "ladder4x.train"])
def test_fault_half_the_batch(root, monkeypatch, cell):
    """The loss is the mean over the first half of the batch."""
    from glass_tpu_torch.train import loop

    for name, fn in list(loop.LOSSES.items()):
        monkeypatch.setitem(
            loop.LOSSES, name,
            lambda logits, y, fn=fn: fn(logits[: len(y) // 2],
                                        y[: len(y) // 2]))
    out = tiny.run(root, cell)
    assert out["correct"] is False


@pytest.mark.parametrize("cell", ["em_user.serve", "hpo_metab.serve"])
def test_fault_answer_altered(root, monkeypatch, cell):
    """One logit of every request is off by a hundredth."""
    from glass_tpu_torch import serve

    call = serve.Predictor.__call__

    def altered(self, subgraphs):
        out = np.array(call(self, subgraphs))
        out[0, 0] += 0.01
        return out

    monkeypatch.setattr(serve.Predictor, "__call__", altered)
    out = tiny.run(root, cell)
    assert out["correct"] is False

"""The port's ``trace``, spans and counters, and ``nan_check_mode``
(``glass_tpu_torch/utils/profiling.py``) on the CPU, beside glass_tpu's.

``trace`` writes one non-empty Chrome trace under the directory it is
given, holding the block's name and its ops. With no profiler, ``span``
returns one shared no-op context and records nothing. Under a profiler a
``Predictor`` request records one ``glass.serve.request`` over one stage,
launch and readback, with counters of its real nodes and its bucket's
slots, and a ``Trainer`` epoch one ``glass.train.epoch`` over one
copy-in, a step span a batch and one readback; a self time is its total
less its children's, and the names (and a request's ident) reach the
Chrome trace; spans on two threads nest each in its own thread's. Each
benchmark reader of the span table (``benchmark/metrics/<name>.py``,
loaded from its file) reads a hand-made table and gives nothing from an
empty one, from a run the card did not trace, or from a program without
the table. ``nan_check_mode`` raises
``FloatingPointError`` where JAX's raises it, at an op that makes a NaN in
the forward (the same inputs through both packages), raises as well at a
backward op that makes one from finite forward values, lets a finite
GNN-seg step through, and leaves autograd's anomaly switches and the
dispatch mode stack as it found them, on a normal exit and on an error.
"""

import importlib.util
import json
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from glass_tpu.utils import profiling as jprof
from glass_tpu_torch import (GLASS, Predictor, TrainConfig, Trainer,
                             build_graph, make_train_batches)
from glass_tpu_torch.nn.seg import GSegGNN
from glass_tpu_torch.utils import profiling as tprof

METRICS = Path(__file__).resolve().parents[1] / "benchmark" / "metrics"
N = 120
SUBS = [[0, 1, 2], [5, 6], [10, 11, 12, 13, 14]]


def switches():
    return (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled(),
            _get_current_dispatch_mode())


def seg_step():
    """One GNN-seg forward and backward at a small size."""
    rng = np.random.default_rng(0)
    adj = torch.from_numpy(rng.random((3, 5, 5), dtype=np.float32))
    feats = torch.from_numpy(rng.random((3, 5, 4), dtype=np.float32))
    mask = torch.ones(3, 5, dtype=torch.bool)
    model = GSegGNN(4, 8, 2, 2, device="cpu")
    model(adj, adj, feats, mask).sum().backward()
    return model


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace("seg_step", str(tmp_path)):
        seg_step()
    files = list(tmp_path.glob("seg_step.*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "seg_step" in names and "aten::bmm" in names


def test_nan_check_mode_raises_in_the_forward_as_jax():
    x = np.array([-1.0, 4.0], np.float32)
    with pytest.raises(FloatingPointError):
        with jprof.nan_check_mode():
            jax.jit(jnp.sqrt)(jnp.asarray(x)).block_until_ready()
    before = switches()
    with pytest.raises(FloatingPointError, match="sqrt"):
        with tprof.nan_check_mode():
            torch.sqrt(torch.from_numpy(x))
    assert switches() == before
    assert torch.isnan(torch.sqrt(torch.from_numpy(x))).any()  # off again


def test_nan_check_mode_raises_in_the_backward():
    before = switches()
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises((FloatingPointError, RuntimeError)):
        with tprof.nan_check_mode():
            y = torch.sqrt(x) * 0.0  # finite: 0; d/dx: 0 * inf = nan
            assert torch.isfinite(y).all()
            y.sum().backward()
    assert switches() == before
    x.grad = None
    (torch.sqrt(x) * 0.0).sum().backward()  # off again: no error
    assert torch.isnan(x.grad).all()


def test_nan_check_mode_lets_a_finite_step_through():
    before = switches()
    with tprof.nan_check_mode():
        assert switches()[2] is not None and torch.is_anomaly_enabled()
        model = seg_step()
    assert switches() == before
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.fixture
def spans():
    """An empty span table before and after the test."""
    tprof.reset_spans()
    yield
    tprof.reset_spans()


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def tiny_glass(rng):
    """A CPU graph of N nodes, degree ids and a one-layer GLASS."""
    src, dst = rng.integers(0, N, 500), rng.integers(0, N, 500)
    ei = np.stack([np.r_[src, dst], np.r_[dst, src]])
    graph = build_graph(ei, None, N, "gcn", device="cpu")
    x = torch.from_numpy(rng.integers(0, 4, (N, 1)))
    model = GLASS(3, 8, 1, (1,), ("size",), dropout=0.5, seed=1,
                  device="cpu")
    return graph, x, model


def test_span_without_a_profiler_records_nothing(spans):
    assert not tprof.recording()
    off = tprof.span("glass.a", 1)
    assert off is tprof.span("glass.b")
    with off, tprof.span("glass.c"):
        tprof.count("c", 3)
    assert tprof.span_table() == {}


def test_self_time_is_total_less_children(spans):
    with profiled():
        assert tprof.recording()
        with tprof.span("glass.outer", 7):
            for _ in range(2):
                with tprof.span("glass.inner"):
                    sum(range(1000))
    t = tprof.span_table()
    outer, inner = t["glass.outer"], t["glass.inner"]
    assert (outer["count"], inner["count"]) == (1, 2)
    assert (outer["parent"], inner["parent"]) == (None, "glass.outer")
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-9)
    assert inner["self_s"] == inner["total_s"] > 0
    tprof.reset_spans()
    assert tprof.span_table() == {}


def test_spans_on_two_threads_nest_apart(spans):
    """A span opened on one thread is no parent of one on another, and
    each thread's inner span is its own outer span's child time."""
    inside = threading.Barrier(2, timeout=30)

    def nest(outer):
        with tprof.span(outer):
            inside.wait()  # both outer spans open at once
            with tprof.span(outer + ".inner"):
                pass
            inside.wait()

    with profiled():
        threads = [threading.Thread(target=nest, args=(f"glass.t{i}",))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    t = tprof.span_table()
    for i in range(2):
        outer, inner = t[f"glass.t{i}"], t[f"glass.t{i}.inner"]
        assert outer["parent"] is None and outer["count"] == 1
        assert inner["parent"] == f"glass.t{i}" and inner["count"] == 1
        assert outer["self_s"] == pytest.approx(
            outer["total_s"] - inner["total_s"], abs=1e-9)


def test_a_request_records_its_spans_and_counters(rng, spans):
    graph, x, model = tiny_glass(rng)
    pred = Predictor(model, graph, x, batch_buckets=(4,),
                     width_buckets=(8,), device="cpu")
    with profiled():
        out = pred(SUBS)
    assert out.shape == (3, 1)
    t = tprof.span_table()
    assert t["glass.serve.request"]["count"] == 1
    assert t["glass.serve.request"]["parent"] is None
    for part in ("stage", "launch", "readback"):
        e = t[f"glass.serve.{part}"]
        assert e["count"] == 1 and e["parent"] == "glass.serve.request"
    assert t["serve.nodes"]["value"] == sum(map(len, SUBS)) == 10
    assert t["serve.slots"]["value"] == 4 * 8
    assert t["serve.nodes"]["parent"] == "glass.serve.stage"
    for name, e in t.items():
        if "self_s" in e:
            assert 0 <= e["self_s"] <= e["total_s"], name
    assert "glass.capture" not in t  # the CPU serves eagerly


def test_trace_holds_the_span_names(rng, tmp_path, spans):
    graph, x, model = tiny_glass(rng)
    pred = Predictor(model, graph, x, device="cpu")
    pred(SUBS)
    with tprof.trace("serve", str(tmp_path)):
        pred(SUBS)
    (path,) = tmp_path.glob("serve.*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"serve", "glass.serve.request", "glass.serve.stage",
            "glass.serve.launch", "glass.serve.readback"} <= names
    (req,) = [e for e in events if e.get("name") == "glass.serve.request"]
    assert req["args"]["ident"] == 2  # the predictor's second request
    assert tprof.span_table()["glass.serve.request"]["count"] == 1


def test_an_epoch_records_its_spans(rng, spans):
    graph, x, model = tiny_glass(rng)
    pos = np.full((12, 6), -1, np.int64)
    for i in range(12):
        pos[i, :3] = rng.choice(N, 3, replace=False)
    y = (np.arange(12) % 2).astype(np.float32)
    trainer = Trainer(model, graph, x, TrainConfig(batch_size=4, loss="bce"))
    trainer.init(0)
    pos_b, y_b = make_train_batches(np.random.default_rng(1), pos, y, 4)
    nb = pos_b.shape[0]
    with profiled():
        res = trainer.train_epoch(pos_b, y_b)
    assert res.step_losses.shape == (nb,)
    t = tprof.span_table()
    assert t["glass.train.epoch"]["count"] == 1
    assert t["glass.train.epoch"]["parent"] is None
    for part, n in (("copy_in", 1), ("step", nb), ("readback", 1)):
        e = t[f"glass.train.{part}"]
        assert e["count"] == n and e["parent"] == "glass.train.epoch"
        assert 0 <= e["self_s"] <= e["total_s"]
    tprof.reset_spans()
    with profiled():
        trainer.train_epochs(np.stack([pos_b] * 2), np.stack([y_b] * 2))
    t = tprof.span_table()
    copy_in = t["glass.train.copy_in"]  # once, before the K epochs
    assert copy_in["count"] == 1 and copy_in["parent"] is None
    assert t["glass.train.epoch"]["count"] == 2
    assert t["glass.train.step"]["count"] == 2 * nb
    assert t["glass.train.readback"]["count"] == 2


SERVE = {
    "glass.serve.request": dict(count=4, total_s=0.004, self_s=0.0001,
                                parent=None),
    "glass.serve.stage": dict(count=4, total_s=0.0012, self_s=0.0012,
                              parent="glass.serve.request"),
    "glass.serve.launch": dict(count=4, total_s=0.0009, self_s=0.0004,
                               parent="glass.serve.request"),
    "glass.capture": dict(count=1, total_s=0.0005, self_s=0.0005,
                          parent="glass.serve.launch"),
    "glass.serve.readback": dict(count=4, total_s=0.0018, self_s=0.0018,
                                 parent="glass.serve.request"),
    "serve.nodes": dict(count=4, value=30, parent="glass.serve.stage"),
    "serve.slots": dict(count=4, value=120, parent="glass.serve.stage"),
}
TRAIN = {
    "glass.train.epoch": dict(count=2, total_s=0.3, self_s=0.001,
                              parent=None),
    "glass.train.step": dict(count=80, total_s=0.02, self_s=0.008,
                             parent="glass.train.epoch"),
    "glass.train.readback": dict(count=2, total_s=0.01, self_s=0.01,
                                 parent="glass.train.epoch"),
}
READINGS = {  # reader: (hand-made table, reading)
    "stage_us.serve": (SERVE, 300.0),
    "launch_us.serve": (SERVE, 100.0),  # the capture left out
    "readback_us.serve": (SERVE, 450.0),
    "bucket_fill.serve": (SERVE, 25.0),
    "launch_us.train": (TRAIN, 100.0),
    "readback_ms.train": (TRAIN, 5.0),
}


def reader(name):
    """The ``read`` of ``benchmark/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", sorted(READINGS))
def test_metric_reads_the_span_table(name, monkeypatch):
    read = reader(name)
    table, want = READINGS[name]
    card = SimpleNamespace(device_trace={"busy_s": 1.0, "window_s": 2.0})
    monkeypatch.setattr(tprof, "span_table", lambda: table)
    assert read(card) == pytest.approx(want)
    assert read(SimpleNamespace(device_trace=None)) is None  # the CPU
    other = SERVE if table is TRAIN else TRAIN
    monkeypatch.setattr(tprof, "span_table", lambda: other)
    assert read(card) is None
    monkeypatch.setattr(tprof, "span_table", dict)
    assert read(card) is None
    monkeypatch.delattr(tprof, "span_table")  # a program without the table
    assert read(card) is None

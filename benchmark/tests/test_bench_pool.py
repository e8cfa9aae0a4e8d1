"""The readers of the pool's metrics, ``pool_bwd_us.train`` and
``pool_fill.train``, on a hand-made span table and kernel list: their
values where the program's counters and the gather backward's kernel are
there, and nothing where either is absent (a program without the
counters, as a parent commit may be), or where the card did not trace
the window."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import byname

METRICS = Path(__file__).resolve().parents[1] / "metrics"
KERNEL = ("void (anonymous namespace)::indexing_backward_kernel<float, 4, "
          "long>(long const*, long const*, float const*, float*)")
TABLE = {
    "train.pool_slots": dict(count=40, value=40 * 80 * 123,
                             parent="glass.train.epoch"),
    "train.pool_nodes": dict(count=40, value=40 * 820,
                             parent="glass.train.epoch"),
    "train.spmm": dict(count=40, value=160, parent="glass.train.step"),
}


def traced(kernels):
    trace = dict(busy_s=1.0, window_s=1.1, kernels=kernels)
    return SimpleNamespace(mode="train", device_trace=trace, trace=trace)


@pytest.fixture
def table(monkeypatch):
    from glass_tpu_torch.utils import profiling

    def use(t):
        monkeypatch.setattr(profiling, "span_table", lambda: dict(t))
    use(TABLE)
    return use


def test_pool_bwd_us_reads_a_step_s_kernel_time(table):
    read = byname.load(METRICS, "pool_bwd_us.train").read
    run = traced({KERNEL: [40, 0.002], "sblock_spmm_kernel<16>": [160, 0.02]})
    assert read(run) == pytest.approx(50.0)  # 2 ms over 40 steps
    run.trace["kernels"][KERNEL.replace("float", "c10::BFloat16")] = [
        40, 0.001]
    assert read(run) == pytest.approx(75.0)


def test_pool_fill_reads_the_counters(table):
    read = byname.load(METRICS, "pool_fill.train").read
    assert read(traced({})) == pytest.approx(820 / (80 * 123) * 100)


@pytest.mark.parametrize("name", ["pool_bwd_us.train", "pool_fill.train"])
def test_silent_without_counters_kernel_or_trace(name, table, monkeypatch):
    from glass_tpu_torch.utils import profiling

    read = byname.load(METRICS, name).read
    run = traced({KERNEL: [40, 0.002]})
    assert read(run) is not None
    assert read(SimpleNamespace(mode="train", device_trace=None)) is None
    table({k: v for k, v in TABLE.items() if k != "train.pool_nodes"})
    if name == "pool_fill.train":
        assert read(run) is None
    table({k: v for k, v in TABLE.items() if not k.startswith("train.pool")})
    assert read(run) is None
    table(TABLE)
    if name == "pool_bwd_us.train":
        assert read(traced({"other_kernel": [40, 0.002]})) is None
    monkeypatch.delattr(profiling, "span_table")  # a program without it
    assert read(run) is None

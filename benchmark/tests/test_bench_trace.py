"""The trace's reduction on a hand-made Chrome trace: device time inside
the window, the union of overlapping events, and idle gaps labelled by
the host's spans."""

import re

import pytest

from benchmark import trace as tr


def ev(name, cat, ts, dur, tid=1):
    return dict(name=name, cat=cat, ph="X", ts=ts, dur=dur, pid=1, tid=tid)


EVENTS = [
    ev("bench.window", "user_annotation", 100, 100),
    ev("bench.request", "user_annotation", 100, 50),
    ev("cudaMemcpyAsync", "cuda_runtime", 105, 20),
    ev("bench.request", "user_annotation", 150, 50),
    ev("cudaGraphLaunch", "cuda_runtime", 160, 5),
    ev("bcsr_tf32_kernel<float>", "kernel", 90, 20, tid=7),  # half inside
    ev("add", "kernel", 130, 20, tid=7),
    ev("mul", "kernel", 140, 30, tid=8),  # overlaps add
    ev("Memcpy DtoH", "gpu_memcpy", 180, 10, tid=7),
    ev("other thread", "cpu_op", 100, 100, tid=2),
]


def test_busy_window_and_ops():
    r = tr.reduce_events(EVENTS)
    assert r["window_s"] == pytest.approx(100e-6)
    # [100, 110] + [130, 170] + [180, 190]
    assert r["busy_s"] == pytest.approx(60e-6)
    assert r["kernels"]["bcsr_tf32_kernel<float>"] == [1, pytest.approx(10e-6)]
    assert [n for n, _ in r["device_ops"]] == [
        "mul", "add", "bcsr_tf32_kernel<float>", "Memcpy DtoH"]


def test_idle_gaps_labelled_by_host_spans():
    r = tr.reduce_events(EVENTS)
    gaps = dict(r["idle_gaps"])
    # [110, 130]: mid 120 inside the copy; [170, 180]: mid 175 inside the
    # second request only; [190, 200]: mid 195 likewise
    assert gaps["bench.request:cudaMemcpyAsync"] == pytest.approx(20e-6)
    assert gaps["bench.request:bench.request"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(40e-6)


def test_one_window_only():
    with pytest.raises(RuntimeError):
        tr.reduce_events(EVENTS + [EVENTS[0]])


def test_kernel_seconds_by_pattern():
    r = tr.reduce_events(EVENTS)
    pat = [re.compile(r"bcsr_tf32_kernel")]
    assert tr.kernel_seconds(r["kernels"], pat) == pytest.approx(10e-6)
    assert tr.kernel_seconds(r["kernels"], [re.compile("nothing")]) is None

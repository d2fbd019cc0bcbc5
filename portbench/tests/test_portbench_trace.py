"""Reading a profiler trace: spans, graph launches, idle time, breakdown."""

import pytest

from portbench import metrics, trace
from portbench.harness import ReadContext


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    """Two groups of 3 steps: an eager step, then graph replays."""
    ev = []
    for g0 in (1000.0, 2000.0):
        ev.append(_x("user_annotation", trace.GROUP_SPAN, g0, 900.0))
        ev.append(_x("cpu_op", "aten::conv2d", g0 + 10, 300.0))
        ev.append(_x("kernel", "eager_kernel", g0 + 20, 100.0))
        for k, at in enumerate((g0 + 500, g0 + 700)):
            ev.append(_x("cuda_runtime", "cudaGraphLaunch", at, 5.0))
            ev.append(_x("kernel", "AdamOp", at + 10, 50.0))
            ev.append(_x("kernel", "replay_kernel", at + 62, 100.0))
        ev.append(_x("gpu_memcpy", "Memcpy DtoH", g0 + 890, 5.0))
    ev.append({"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1.0})
    return ev


def test_parse_and_window():
    t = trace.parse(_events())
    assert t.groups == [(1000e-6, 1900e-6), (2000e-6, 2900e-6)]
    assert len(t.graph_launches) == 4 and len(t.kernels) == 10 and len(t.device) == 12
    assert t.window_s == pytest.approx(1900e-6)
    # busy: per group 100 + 2 * (50 + 100) + 5 us
    assert t.busy_s() == pytest.approx(2 * 405e-6)


def test_loop_and_idle_readers():
    ctx = ReadContext({}, {}, trace.parse(_events()), steps=3)
    assert metrics.load("loop.first_replay_ms").read(ctx) == pytest.approx(0.5)
    # (900 - 500) us over 2 replays
    assert metrics.load("loop.replay_ms").read(ctx) == pytest.approx(0.2)
    assert metrics.load("device.idle_share").read(ctx) == pytest.approx(
        100 * (1 - 810 / 1900))


def test_loop_readers_are_silent_without_graphs():
    ev = [e for e in _events() if e["name"] != "cudaGraphLaunch"]
    ctx = ReadContext({}, {}, trace.parse(ev), steps=1)
    assert metrics.load("loop.first_replay_ms").read(ctx) is None
    assert metrics.load("loop.replay_ms").read(ctx) is None


def test_breakdown_names_ops_and_what_the_host_did():
    b = trace.breakdown(trace.parse(_events()))
    ops = dict(b["device_ops"])
    assert ops["replay_kernel"] == pytest.approx(400e-6)
    assert ops["AdamOp"] == pytest.approx(200e-6)
    gaps = dict(b["idle_gaps"])
    # the gap in the middle of the eager op is labelled by it
    assert gaps["aten::conv2d"] > 0
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    idle = sum(v for _, v in b["idle_gaps"])
    assert idle == pytest.approx(1900e-6 - 810e-6)


def test_step_mfu_counts_traced_groups():
    t = trace.parse(_events())
    ctx = ReadContext({}, {}, t, steps=3, _flops=989e12 * 1900e-6 / 2)
    assert metrics.load("step_mfu").read(ctx) == pytest.approx(100.0)

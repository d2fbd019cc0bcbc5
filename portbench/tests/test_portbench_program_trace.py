"""Reading the program's own trace: its host spans per group, the device's
idle time inside them, and the per-module device ms of its replays."""

import sys
import types

import pytest

from portbench import metrics, program_trace, trace
from portbench.harness import ReadContext

HOST = ("loop.prepare_ms", "loop.warmup_ms", "loop.capture_ms", "loop.overhead_idle_ms")
REPLAY = ("replay.encoder_ms", "replay.synthesis_ms", "replay.vgg16_ms", "replay.backward_ms",
          "replay.other_ms")


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    """Two groups of 3 steps, the program's spans inside each: prepare
    100 us, warm-up 200 us (its eager kernel 120 us of it), capture 150 us
    (a copy 30 us), then two replays of 10 and 20 us on the host."""
    ev = []
    for g0 in (1000.0, 2000.0):
        ev.append(_x("user_annotation", trace.GROUP_SPAN, g0, 900.0))
        ev.append(_x("user_annotation", "runner.dispatch", g0 + 5, 890.0))
        ev.append(_x("user_annotation", "attack.prepare", g0 + 10, 100.0))
        ev.append(_x("user_annotation", "program.warmup", g0 + 110, 200.0))
        ev.append(_x("kernel", "eager_kernel", g0 + 150, 120.0))
        ev.append(_x("user_annotation", "program.capture", g0 + 310, 150.0))
        ev.append(_x("gpu_memcpy", "Memcpy DtoD", g0 + 400, 30.0))
        for at, host in ((g0 + 500, 10.0), (g0 + 700, 20.0)):
            ev.append(_x("user_annotation", "program.replay", at - 2, host))
            ev.append(_x("cuda_runtime", "cudaGraphLaunch", at, 5.0))
            ev.append(_x("kernel", "replay_kernel", at + 10, 150.0))
    return ev


def _ctx(ev):
    return ReadContext({}, {}, trace.parse(ev), steps=3)


def test_host_spans_per_group():
    ctx = _ctx(_events())
    read = {m: metrics.load(m).read(ctx) for m in HOST}
    assert read["loop.prepare_ms"] == pytest.approx(0.1)
    assert read["loop.warmup_ms"] == pytest.approx(0.2)
    assert read["loop.capture_ms"] == pytest.approx(0.15)
    # each group's replay spans are found in it (read by no metric)
    assert [len(g) for g in program_trace.spans_by_group(ctx, "program.replay")] == [2, 2]
    # 450 us of spans, 150 us of them with the device busy
    assert read["loop.overhead_idle_ms"] == pytest.approx(0.3)
    # the three phases are the time before the first launch but for the
    # 10 us before the prepare and the 40 us after the capture
    first = metrics.load("loop.first_replay_ms").read(ctx)
    assert first == pytest.approx(0.01 + 0.45 + 0.04)


def test_a_group_without_a_phase_reads_zero_for_it():
    ev = [e for e in _events() if not (e["name"] == "program.capture" and e["ts"] > 2000)]
    assert metrics.load("loop.capture_ms").read(_ctx(ev)) == pytest.approx(0.075)


def test_overlapping_spans_count_their_idle_time_once():
    ev = _events() + [_x("user_annotation", "attack.prepare", 1400.0, 80.0)]
    ctx = _ctx(ev)
    # group 0's spans reach 20 us further, all of it idle; group 1 unchanged
    assert program_trace.overhead_idle_ms(ctx) == pytest.approx(1e-3 * (320 + 300) / 2)
    assert program_trace.overlap([[0, 2], [3, 5]], [[1, 4]]) == pytest.approx(2)
    assert program_trace.union([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]


def test_host_readers_are_silent_without_the_programs_spans():
    ev = [e for e in _events() if e["cat"] != "user_annotation" or e["name"] == trace.GROUP_SPAN]
    ctx = _ctx(ev)
    assert all(metrics.load(m).read(ctx) is None for m in HOST)


def test_replay_readers(monkeypatch):
    rows = [dict(step=80.0, encoder=10.0, synthesis=20.0, vgg16=5.0, backward=40.0),
            dict(step=90.0, encoder=12.0, synthesis=22.0, vgg16=7.0, backward=42.0)]
    monkeypatch.setitem(sys.modules, program_trace.TRACER,
                        types.SimpleNamespace(replay_ms=lambda: rows))
    ctx = _ctx(_events())
    read = {m: metrics.load(m).read(ctx) for m in REPLAY}
    assert read == pytest.approx({"replay.encoder_ms": 11.0, "replay.synthesis_ms": 21.0,
                                  "replay.vgg16_ms": 6.0, "replay.backward_ms": 41.0,
                                  "replay.other_ms": 6.0})


def test_replay_readers_are_silent_without_the_record(monkeypatch):
    ctx = _ctx(_events())
    monkeypatch.delitem(sys.modules, program_trace.TRACER, raising=False)
    assert all(metrics.load(m).read(ctx) is None for m in REPLAY)
    # a tracer that recorded no replay
    monkeypatch.setitem(sys.modules, program_trace.TRACER,
                        types.SimpleNamespace(replay_ms=lambda: []))
    assert all(metrics.load(m).read(ctx) is None for m in REPLAY)

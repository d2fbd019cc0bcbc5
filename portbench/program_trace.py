"""The program's own trace, as the per-layer readers read it.

The port records, while a profiler session records (its
``tpufusion_torch/core/trace.py``):

- host spans, ``user_annotation`` events of the profiler's trace beside the
  benchmark's group spans (``ctx.trace.host``): ``runner.dispatch`` (a
  group's call), ``attack.prepare`` (the attack's inputs, its no-grad
  reference bundle, its step programs looked up or built, and loaded),
  ``program.warmup`` (the eager first step and the wait for it),
  ``program.capture`` (the CUDA graph's capture and instantiation) and
  ``program.replay`` (one call's graph launches; no metric reads it, since
  under the profiler a launch waits for most of its replay);
- for each step program captured while it recorded, the device ms of each
  device span in the program's last replay (``replay_ms()``): ``step``,
  ``encoder``, ``synthesis``, ``vgg16`` and ``backward``.

The readers find the port's tracer where the program loaded it
(``sys.modules``): ``program.py`` stays the one module of the benchmark
that imports the port. A program without these spans or this record (one
older than its tracer) gives nothing to read, and each reader returns None.
"""

from __future__ import annotations

import sys

TRACER = "tpufusion_torch.core.trace"
DISPATCH = "runner.dispatch"
OVERHEAD = ("attack.prepare", "program.warmup", "program.capture")
MODULES = ("encoder", "synthesis", "vgg16", "backward")


def spans_by_group(ctx, name: str) -> list:
    """For each traced group, the ``(start, end)`` of the host spans
    ``name`` inside it, in seconds on the profiler's clock."""
    spans = sorted((s, s + d) for n, s, d in ctx.trace.host if n == name)
    return [[(s, e) for s, e in spans if gs <= s and e <= ge] for gs, ge in ctx.trace.groups]


def traced(ctx) -> bool:
    """Whether the program recorded its spans: a ``runner.dispatch`` span
    in some traced group."""
    return any(spans_by_group(ctx, DISPATCH))


def group_mean_ms(ctx, name: str):
    """The summed duration of the spans ``name`` in each traced group, the
    mean over the groups (0 for a group without one); None where the
    program recorded no spans."""
    if not traced(ctx):
        return None
    per = spans_by_group(ctx, name)
    return 1e3 * sum(e - s for group in per for s, e in group) / len(per)


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overhead_idle_ms(ctx):
    """Per traced group, the device's idle time inside the union of that
    group's ``attack.prepare``, ``program.warmup`` and ``program.capture``
    spans (their length less the device intervals that fall in them), the
    mean over the groups; None where the program recorded no spans."""
    if not traced(ctx):
        return None
    per = [[] for _ in ctx.trace.groups]
    for name in OVERHEAD:
        for i, spans in enumerate(spans_by_group(ctx, name)):
            per[i].extend(spans)
    busy = ctx.trace.busy_intervals()
    idle = []
    for spans in per:
        u = union(spans)
        idle.append(sum(e - s for s, e in u) - overlap(u, busy))
    return 1e3 * sum(idle) / len(idle)


def replays() -> list:
    """The port's ``{span: ms}`` of each traced program's last replay; []
    where the program has no such record."""
    tracer = sys.modules.get(TRACER)
    return tracer.replay_ms() if tracer is not None else []


def replay_mean_ms(name: str):
    """Device span ``name`` of each traced program's last replay, the mean
    over the programs that have it; None where none has."""
    rows = [r[name] for r in replays() if name in r]
    return sum(rows) / len(rows) if rows else None


def replay_other_ms():
    """``step`` less ``encoder``, ``synthesis``, ``vgg16`` and ``backward``
    (the loss terms, the Adam update and the trace writes), the mean over
    the programs that have all five; None where none has."""
    rows = [r["step"] - sum(r[m] for m in MODULES) for r in replays()
            if all(k in r for k in ("step",) + MODULES)]
    return sum(rows) / len(rows) if rows else None

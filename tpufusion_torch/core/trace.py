"""The program's own tracing: host spans on the profiler's clock, device
spans inside a CUDA graph's replay, and the kernels' launch counts.

Spans record only while a ``torch.profiler`` session records: the switch is
the profiler's own flag (``torch.autograd.profiler._is_profiler_enabled``),
and there is no other. Off, a span costs one read of that flag: no
``record_function``, no event, no synchronisation.

- ``span(name)``: a host span, a ``torch.profiler.record_function`` range,
  so a ``user_annotation`` event of the profiler's trace, on the clock of
  the device's kernels and copies; ``begin`` / ``end`` open and close one
  across calls; ``spanned(name)`` makes each call of a function one.
- ``device_span(name)``: inside a step program's capture made while tracing
  (``capture()``, ``core/graphs.py``), two timing events around the region,
  ``external`` so that the capture makes them event-record nodes of the
  graph: each replay records them again. Elsewhere (tracing off, the CPU,
  an eager step) it does nothing. ``replay_ms()`` reads every such
  program's last replay.
- ``LAUNCHES``: the kernel wrappers' launch counts (``ops.launch_counts``
  reads them), always on: a wrapper adds 1 when its Python runs.

The record is the process's: every program captured while tracing keeps its
events here after its attack object is gone.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

# styled_conv_bwd / styled_conv_up_bwd count the backward's kernel pairs;
# styled_conv_bwd_composite each backward on the card that recomputes the
# composite instead (ops/styled_conv.py::backward_takes)
LAUNCHES = dict.fromkeys(("styled_conv", "styled_conv_up", "conv3x3_fwd", "conv3x3_dgrad",
                          "conv3x3_wgrad", "pgd_update", "fused_adam", "styled_conv_bwd",
                          "styled_conv_up_bwd", "styled_conv_bwd_composite"), 0)
_OFF = contextlib.nullcontext()


class ProgramRecord:
    """The device spans of one program's capture: ``(name, start event, end
    event)`` each; ``replayed`` once a replay has recorded them."""

    def __init__(self):
        self.pairs: list = []
        self.replayed = False


PROGRAMS: list = []  # a ProgramRecord for each program captured while tracing
_capturing = None  # the ProgramRecord of the capture in progress, while tracing


def count(name: str, n: int = 1) -> None:
    """Add ``n`` launches of kernel wrapper ``name``."""
    LAUNCHES[name] += n


def span(name: str):
    """A host span around a ``with`` block while tracing; a shared no-op
    otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """A decorator: each call of the function is a host span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def begin(name: str):
    """Open a host span that a later call closes (``end``); None while not
    tracing."""
    if not _profiler._is_profiler_enabled:
        return None
    handle = torch.profiler.record_function(name)
    handle.__enter__()
    return handle


def end(handle) -> None:
    """Close a span that ``begin`` opened (nothing for None)."""
    if handle is not None:
        handle.__exit__(None, None, None)


@contextlib.contextmanager
def capture():
    """Around a step program's capture: while tracing, the device spans of
    the body go into a new ``ProgramRecord``, kept in ``PROGRAMS`` if the
    capture succeeds and holds any. Yields that record, or None."""
    global _capturing
    if not _profiler._is_profiler_enabled:
        yield None
        return
    record = _capturing = ProgramRecord()
    try:
        yield record
    finally:
        _capturing = None
    if record.pairs:
        PROGRAMS.append(record)


@contextlib.contextmanager
def _device_span(record, name):
    start = torch.cuda.Event(enable_timing=True, external=True)
    stop = torch.cuda.Event(enable_timing=True, external=True)
    start.record()
    yield
    stop.record()
    record.pairs.append((name, start, stop))


def device_span(name: str):
    """Device time of a ``with`` block in each replay of the program being
    captured while tracing (see the module note); a shared no-op
    otherwise."""
    if _capturing is None:
        return _OFF
    return _device_span(_capturing, name)


def replay_ms(first: int = 0) -> list:
    """For each program captured while tracing that has replayed (from
    ``PROGRAMS[first]`` on), ``{span: ms}`` of its last replay, same-named
    spans summed. Waits for the device once."""
    done = [r for r in PROGRAMS[first:] if r.replayed]
    if not done:
        return []
    torch.cuda.synchronize()
    out = []
    for r in done:
        ms: dict = {}
        for name, start, stop in r.pairs:
            ms[name] = ms.get(name, 0.0) + start.elapsed_time(stop)
        out.append(ms)
    return out

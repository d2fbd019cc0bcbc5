"""Infra utilities (port of ``tpufusion/utils/logging.py``; reference C21,
``dnnlib.util``, plus the observability the reference lacks).

- ``EasyDict``: attribute-style dict (`dnnlib/util.py:40`).
- ``Logger``: stdout/stderr tee to a file (`dnnlib/util.py:56-117`).
- ``trace_profile``: context manager writing a ``torch.profiler`` chrome
  trace into a directory, and beside it each traced step program's device
  ms by span in its last replay (``core/trace.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Any, Optional

import torch


class EasyDict(dict):
    """dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]


class _StderrTee:
    """Companion stream: writes reach the log file AND the real stderr —
    crash tracebacks/warnings land in the one artifact inspected after a
    failed run."""

    def __init__(self, logger: "Logger"):
        self._logger = logger

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self._logger.file is not None:
            self._logger.file.write(text)
        self._logger.stderr.write(text)
        if self._logger.should_flush:
            self.flush()

    def flush(self) -> None:
        if self._logger.file is not None:
            self._logger.file.flush()
        self._logger.stderr.flush()


class Logger:
    """Tee stdout (and, by default, stderr) to a log file — the dnnlib
    Logger behaviour the reference wraps its scripts in."""

    def __init__(self, file_name: Optional[str] = None, mode: str = "w",
                 should_flush: bool = True, capture_stderr: bool = True):
        self.file = open(file_name, mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        self._stderr_tee = _StderrTee(self) if capture_stderr else None
        sys.stdout = self
        if self._stderr_tee is not None:
            sys.stderr = self._stderr_tee

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        if sys.stdout is self:
            sys.stdout = self.stdout
        if self._stderr_tee is not None and sys.stderr is self._stderr_tee:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None


def aggregate_loss_dict(agg_loss_dict):
    """Mean per key over a list of loss dicts (`utils/train_utils.py:2-13`)."""
    mean_vals: dict = {}
    for output in agg_loss_dict:
        for key, val in output.items():
            mean_vals.setdefault(key, []).append(val)
    return {
        key: (sum(vals) / len(vals)) if vals else 0
        for key, vals in mean_vals.items()
    }


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """``with trace_profile(dir):`` records the region with ``torch.profiler``
    (CPU, and CUDA when a card is present) and writes a chrome trace,
    ``dir/trace.json``, when it ends, and ``dir/replay_ms.json``: for each
    step program captured while it recorded, ``{span: ms}`` of its last
    replay (``trace.replay_ms()``; a list, empty on the CPU), and then drops
    those programs from the tracer's record."""
    from torch.profiler import ProfilerActivity, profile

    from tpufusion_torch.core import trace

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first = len(trace.PROGRAMS)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "replay_ms.json"), "w") as f:
        json.dump(trace.replay_ms(first), f, indent=1)
    del trace.PROGRAMS[first:]  # written: the record holds each traced program until read

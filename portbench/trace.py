"""The traced window: torch.profiler around whole groups, and its reading.

The harness runs the traced groups under ``torch.profiler`` (CPU and CUDA
activity, no shapes, no stacks), each group inside a
``record_function(GROUP_SPAN)`` span that ends after the device has
finished it. The trace is exported as Chrome JSON (written by the
profiler's own C++ code into the run's temporary directory), read here once
and deleted. ``TEARDOWN_CUPTI=1`` must be set before torch is imported:
without it CUPTI stays on after the session and slows every later graph
replay.

``Trace`` holds what the per-layer readers need, in seconds on the
profiler's clock: the device's kernels, every device interval (kernels,
copies, fills), the CUDA graph launches, the host's events and the groups'
spans. The traced window runs from the first group's span start to the
last group's span end.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

GROUP_SPAN = "portbench.group"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SHORT_GAP_S = 10e-6  # gaps below this are the launch-to-launch spacing


@dataclass
class Trace:
    kernels: list = field(default_factory=list)  # (name, start s, duration s)
    device: list = field(default_factory=list)  # (name, start s, duration s)
    graph_launches: list = field(default_factory=list)  # start s
    host: list = field(default_factory=list)  # (name, start s, duration s)
    groups: list = field(default_factory=list)  # (start s, end s)

    @property
    def window(self):
        return (self.groups[0][0], self.groups[-1][1]) if self.groups else (0.0, 0.0)

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def busy_intervals(self):
        """The union of the device intervals inside the window, sorted."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d in self.device
                       if s + d > lo and s < hi)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())


def start():
    """Start a profiler session (CPU and CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False, profile_memory=False)
    prof.__enter__()
    return prof


def stop(prof) -> Trace:
    """End the session and read its trace."""
    prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def parse(events) -> Trace:
    """A ``Trace`` from Chrome trace events (``ts`` and ``dur`` in us)."""
    t = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s, d = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            t.device.append((name, s, d))
            if cat == "kernel":
                t.kernels.append((name, s, d))
        elif cat in HOST_CATS:
            if cat == "user_annotation" and name == GROUP_SPAN:
                t.groups.append((s, s + d))
                continue
            if cat == "cuda_runtime" and name.startswith("cudaGraphLaunch"):
                t.graph_launches.append(s)
            t.host.append((name, s, d))
    t.groups.sort()
    t.graph_launches.sort()
    return t


def _label(host_sorted, starts, mid) -> str:
    """The innermost host event running at ``mid``: the latest started one
    that has not ended."""
    import bisect

    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(i - 4000, -1), -1):
        name, s, d = host_sorted[j]
        if s + d >= mid:
            return name
    return "host (no event)"


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing (gaps of at least ``SHORT_GAP_S``, each labelled by
    the innermost host event at its middle; the shorter gaps together)."""
    by_op: dict = {}
    lo, hi = t.window
    for name, s, d in t.device:
        if s + d > lo and s < hi:
            by_op[name] = by_op.get(name, 0.0) + d
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    host_sorted = sorted(t.host, key=lambda h: h[1])
    starts = [h[1] for h in host_sorted]
    gaps: dict = {}
    prev = lo
    short = 0.0
    for s, e in t.busy_intervals() + [[hi, hi]]:
        g = s - prev
        if g >= SHORT_GAP_S:
            label = _label(host_sorted, starts, prev + g / 2)
            gaps[label] = gaps.get(label, 0.0) + g
        elif g > 0:
            short += g
        prev = max(prev, e)
    if short:
        gaps[f"between launches (gaps < {SHORT_GAP_S * 1e6:.0f} us)"] = short
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ops=[[k[:200], v] for k, v in ops],
                idle_gaps=[[k[:200], v] for k, v in idle])

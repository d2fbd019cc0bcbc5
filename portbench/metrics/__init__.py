"""Per-layer metrics: one reader a metric, ``<metric name>.py``.

A reader's ``read(ctx)`` returns the metric's value from the traced run,
or None where it finds nothing to read (the harness then leaves the metric
out of the line). ``ctx`` (``harness.ReadContext``) carries the cell's
configuration and traffic mix, the parsed trace (``trace.Trace``), the
steps of a group and the group's operations (``ctx.group_flops()``).
BENCHMARK.json gives each metric's unit, layer and the end-to-end metric it
moves.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics._{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

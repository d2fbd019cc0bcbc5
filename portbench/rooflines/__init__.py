"""Bytes and operations of the hand-written kernels, from shapes.

Each module ``<kernel>.py`` gives ``KERNEL``, the text that the profiler's
name of the kernel's launches contains, and ``cycle_bounds(config, use)``:
the bound in seconds (``peaks.bound_s``) of each launch of the kernel in
one step, in the order a step launches them. ``use`` is the traffic mix's
``per_step`` entry for the kernel (the batch it runs at), so that a new mix
states its launches as data. ``read`` turns the launches a trace saw into
the kernel's share of its roofline.
"""

from __future__ import annotations

import importlib


def load(kernel: str):
    return importlib.import_module(f"portbench.rooflines.{kernel}")


def count(value, config) -> int:
    """A batch as a mix gives it: a number, or ``"n_inputs"``, the
    configuration's group size."""
    return int(config["n_inputs"]) if value == "n_inputs" else int(value)


def read(kernel: str, ctx):
    """The summed bound of the kernel's launches in the traced window over
    their summed device time, in %; None where the mix does not launch it,
    the window saw none, or not a whole number of steps' launches (a count
    with no matching shapes has no bound to set against it)."""
    use = ctx.mix.get("per_step", {}).get(kernel)
    if use is None:
        return None
    mod = load(kernel)
    cycle = mod.cycle_bounds(ctx.config, use)
    times = [dur for name, _, dur in ctx.trace.kernels if mod.KERNEL in name]
    if not times or not cycle or len(times) % len(cycle):
        return None
    bound = sum(cycle) * (len(times) // len(cycle))
    return 100.0 * bound / sum(times)

"""``fused_adam_roofline`` (%; kernels; moves ``attack_step_ms``): the
summed bound of the traced window's launches of ``fused_adam``'s kernel, from
the cell's shapes (``rooflines/fused_adam.py``), over their summed device time
in the profiler's trace."""

from portbench import rooflines


def read(ctx):
    return rooflines.read("fused_adam", ctx)

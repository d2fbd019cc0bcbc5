"""``styled_conv_roofline`` (%; kernels; moves ``attack_step_ms``): the
summed bound of the traced window's launches of ``styled_conv``'s kernel, from
the cell's shapes (``rooflines/styled_conv.py``), over their summed device time
in the profiler's trace."""

from portbench import rooflines


def read(ctx):
    return rooflines.read("styled_conv", ctx)

"""``pgd_update_roofline`` (%; kernels; moves ``attack_step_ms``): the
summed bound of the traced window's launches of ``pgd_update``'s kernel, from
the cell's shapes (``rooflines/pgd_update.py``), over their summed device time
in the profiler's trace."""

from portbench import rooflines


def read(ctx):
    return rooflines.read("pgd_update", ctx)

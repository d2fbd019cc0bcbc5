"""``step_mfu`` (%; the whole step; moves ``attack_step_ms``): the
operations of the traced groups, counted on the plain reference
(``flops.py``), over the traced window times the card's bf16 peak
(989 TFLOP/s, ``peaks.py``). The harness prints the card's power limit
beside it."""

from portbench.peaks import PEAK_OPS_PER_S


def read(ctx):
    window = ctx.trace.window_s
    if window <= 0 or not ctx.trace.groups:
        return None
    flops = ctx.group_flops() * len(ctx.trace.groups)
    return 100.0 * flops / (window * PEAK_OPS_PER_S["bfloat16"])

"""``device.idle_share`` (%; device; moves ``attack_step_ms``): the share
of the traced window in which no kernel, copy or fill ran on the card (the
union of the profiler's device intervals)."""


def read(ctx):
    window = ctx.trace.window_s
    if window <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / window)

"""``loop.overhead_idle_ms`` (ms; device, by program phase; moves
``attack_step_ms``): in each traced group, the device's idle time (no
kernel, copy or fill) inside the program's ``attack.prepare``,
``program.warmup`` and ``program.capture`` spans, the mean over the groups
(``program_trace.py``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.overhead_idle_ms(ctx)

"""``loop.warmup_ms`` (ms; attack loop; moves ``attack_step_ms``): the
program's ``program.warmup`` spans summed in each traced group, the mean
over the groups: a new step program's eager first step and the wait for its
device work (``program_trace.py``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.group_mean_ms(ctx, "program.warmup")

"""``loop.prepare_ms`` (ms; runner and attack loop; moves
``attack_step_ms``): the program's ``attack.prepare`` spans summed in each
traced group, the mean over the groups: the attack's inputs, its no-grad
reference bundle, its step programs looked up or built, and loaded
(``program_trace.py``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.group_mean_ms(ctx, "attack.prepare")

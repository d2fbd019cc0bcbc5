"""``replay.vgg16_ms`` (ms; models in a replay; moves ``attack_step_ms``): the
device time of the program's ``vgg16`` span (both VGG16 forwards) in each
traced step program's last replay, the mean over the programs
(``program_trace.py``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.replay_mean_ms("vgg16")

"""``replay.other_ms`` (ms; loss, update; moves ``attack_step_ms``): the
device time of the program's ``step`` span in each traced step program's
last replay less its ``encoder``, ``synthesis``, ``vgg16`` and ``backward``
spans: the loss terms, the Adam update and the trace writes, the mean over
the programs (``program_trace.py``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.replay_other_ms()

"""``loop.capture_ms`` (ms; attack loop; moves ``attack_step_ms``): the
program's ``program.capture`` spans summed in each traced group, the mean
over the groups: ``torch.cuda.graph``'s entry (a synchronize, the
allocator's cache emptied), the capture, the instantiation and the closing
synchronize (``program_trace.py``)."""

from portbench import program_trace


def read(ctx):
    return program_trace.group_mean_ms(ctx, "program.capture")

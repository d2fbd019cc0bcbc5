"""``loop.first_replay_ms`` (ms; runner and attack loop; moves
``attack_step_ms``): the time from a group's ``dispatch_attack`` call to
its first CUDA graph launch, the mean over the traced groups. It is what a
group pays before its replays: the attack object, the no-grad reference
bundle, the eager first step and the capture. From the benchmark's span
around each call and the profiler's ``cudaGraphLaunch`` runtime events;
nothing where the groups launch no graph."""

import bisect


def first_launches(ctx):
    """(group start, first graph launch in it, group end) of each traced
    group that launched a graph."""
    out = []
    launches = ctx.trace.graph_launches
    for s, e in ctx.trace.groups:
        i = bisect.bisect_left(launches, s)
        if i < len(launches) and launches[i] <= e:
            out.append((s, launches[i], e))
    return out


def read(ctx):
    rows = first_launches(ctx)
    if not rows:
        return None
    return 1e3 * sum(f - s for s, f, _ in rows) / len(rows)

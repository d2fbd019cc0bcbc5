"""``loop.replay_ms`` (ms; attack loop, steady; moves ``attack_step_ms``):
a group's time from its first CUDA graph launch to its end over its steps
less one (the replays after the eager first step), the mean over the
traced groups; nothing where the groups launch no graph or take one
step."""

from portbench.metrics import load


def read(ctx):
    rows = load("loop.first_replay_ms").first_launches(ctx)
    if not rows or ctx.steps < 2:
        return None
    return 1e3 * sum((e - f) / (ctx.steps - 1) for _, f, e in rows) / len(rows)

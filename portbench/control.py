"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/control.py --workload <cell> --program-seeds 1,2,... \\
        --control-seeds 1,2,3 [--fault-seeds 1,2,3 --faults a,b] [--out control.jsonl]

For each seed, at the cell's own sizes: the program runs group 0 of the
seed through ``dispatch_attack`` (after one short warm-up group, as a run
does), and the float32 reference follows the same group, and the short
groups where the mix compares them (``check.short``, run after it as a run
does); the numbers that the harness compares are read between the two (the
program's readings, the lower end of each limit). For a control seed the
reference runs once more in place of the program, its products in float8
(``reference/numerics.py``, the step below the port's bfloat16), and the
same numbers are read between it and the float32 reference (the control's
readings, the upper end). For a fault seed the program runs the same
groups again with each named fault of the cell's attack
(``tests/faults/<attack>.py``) planted in it (``fault.<name>``: the
readings a fault gives). One JSON line a seed, to stdout and to ``--out``.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TEARDOWN_CUPTI"] = "1"
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def _answers(pipeline, config, mix, seed, device) -> dict:
    """The program's answers ``{index: tensor}`` for the warm-up group, group
    0 and the short groups, as a run makes them."""
    from portbench import harness, program, traffic

    n, size = int(config["n_inputs"]), int(config["generator"]["size"])
    out = {}
    for index, settings in ((traffic.WARMUP_GROUP, {**mix["run_config"], **mix["warmup"]}),
                            (0, mix["run_config"])):
        images, target, gen = traffic.group_inputs(seed, index, n, size, mix["images"], device)
        out[index] = program.dispatch(pipeline, mix["attack"], images, target,
                                      program.run_config(config, mix["attack"], settings),
                                      gen).detach().clone()
    out.update(harness.short_answers(pipeline, config, mix, seed, device))
    return out


def readings(cell: str, seed: int, *, run_program: bool, run_control: bool, faults=(),
             device="cuda", overrides: dict = None) -> dict:
    """One seed's readings: ``{"program": numbers, "control": numbers,
    "fault.<name>": numbers}`` (each left out when not asked for), whether
    each is correct by the cell's limits (``harness.judge``), and the
    seconds each part took."""
    import torch

    from portbench import harness, program, traffic, weights
    from portbench.reference import attacks
    from portbench.reference.numerics import Numerics, no_tf32

    _, _, config, mix, limits = harness.load_cell(cell)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("mix", {})}
    device = torch.device(device)
    out = dict(cell=cell, seed=seed)
    # the groups compared: the window's group 0, and the short groups
    indices = list(harness.short_groups(mix)) + [0]
    sides = {}
    if run_program or faults:
        t = time.perf_counter()
        if device.type == "cuda":
            program.load_kernels()
        pipeline = harness.build_program(config, seed, device)
        if run_program:
            sides["program"] = _answers(pipeline, config, mix, seed, device)
        for name in faults:
            import pytest

            from portbench.tests import faults as planted

            with pytest.MonkeyPatch.context() as mp:
                planted.load(mix["attack"])[name](mp)
                sides["fault." + name] = _answers(pipeline, config, mix, seed, device)
        del pipeline
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        out["program_s"] = time.perf_counter() - t
    with no_tf32():
        mod = attacks.load(mix["attack"])
        state = weights.make_state(config, seed, device)
        models = weights.reference_models(config, state, Numerics("float32"))
        low = weights.reference_models(config, state, Numerics("float8")) if run_control else None
        out["reference_s"] = out["control_s"] = 0.0
        for index in indices:
            gmix = harness.group_mix(mix, index)
            group = harness.reference_group(config, gmix, seed, index, device, models)
            t = time.perf_counter()
            followed = mod.follow(models, gmix, group)
            out["reference_s"] += time.perf_counter() - t
            for side, answers in sides.items():
                out.setdefault(side, {}).update(harness.named(
                    mix, index, mod.numbers(models, gmix, group, answers[index].to(device),
                                            followed)))
            if run_control:
                t = time.perf_counter()
                ctrl = mod.answer(low, gmix, group).permute(0, 2, 3, 1).contiguous()
                out["control_s"] += time.perf_counter() - t
                out.setdefault("control", {}).update(harness.named(
                    mix, index, mod.numbers(models, gmix, group, ctrl, followed)))
        for side in ["program", "control"] + ["fault." + f for f in faults]:
            if side in out:
                out[side + "_correct"] = harness.judge(out[side], limits)
        if not run_control:
            del out["control_s"]
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="", help="names of the faults in tests/faults/<attack>.py")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    prog = [int(s) for s in args.program_seeds.split(",") if s]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    fault = [int(s) for s in args.fault_seeds.split(",") if s]
    names = [f for f in args.faults.split(",") if f]
    for seed in dict.fromkeys(prog + ctrl + fault):
        line = json.dumps(readings(args.workload, seed, run_program=seed in prog,
                                   run_control=seed in ctrl,
                                   faults=names if seed in fault else ()))
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

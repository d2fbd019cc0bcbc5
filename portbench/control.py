"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/control.py --workload <cell> --program-seeds 1,2,... \\
        --control-seeds 1,2,3 [--out control.jsonl]

For each seed, at the cell's own sizes: the program runs group 0 of the
seed through ``dispatch_attack`` (after one short warm-up group, as a run
does), and the float32 reference follows the same group; the numbers that
the harness compares are read between the two (the program's readings, the
lower end of each limit). For a control seed the reference runs once more
in place of the program, its products in float8 (``reference/numerics.py``,
the step below the port's bfloat16), and the same numbers are read between
it and the float32 reference (the control's readings, the upper end). One
JSON line a seed, to stdout and to ``--out``.
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


def readings(cell: str, seed: int, *, run_program: bool, run_control: bool, device="cuda",
             overrides: dict = None) -> dict:
    """One seed's readings: ``{"program": numbers, "control": numbers}``
    (either left out when not asked for), whether each is correct by the
    cell's limits (``harness.judge``), and the seconds each part took."""
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
    prog_adv = None
    if run_program:
        t = time.perf_counter()
        if device.type == "cuda":
            program.load_kernels()
        pipeline = harness.build_program(config, seed, device)
        n, size = int(config["n_inputs"]), int(config["generator"]["size"])
        for index, settings in ((traffic.WARMUP_GROUP, {**mix["run_config"], **mix["warmup"]}),
                                (0, mix["run_config"])):
            images, target, gen = traffic.group_inputs(seed, index, n, size, mix["images"],
                                                       device)
            prog_adv = program.dispatch(pipeline, mix["attack"], images, target,
                                        program.run_config(config, mix["attack"], settings),
                                        gen).detach().clone()
        del pipeline, images, target, gen
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        out["program_s"] = time.perf_counter() - t
    with no_tf32():
        mod = attacks.load(mix["attack"])
        group = harness.reference_group(config, mix, seed, 0, device)
        state = weights.make_state(config, seed, device)
        models = weights.reference_models(config, state, Numerics("float32"))
        t = time.perf_counter()
        followed = mod.follow(models, mix, group)
        out["reference_s"] = time.perf_counter() - t
        if run_program:
            out["program"] = mod.numbers(models, mix, group, prog_adv, followed)
            out["program_correct"] = harness.judge(out["program"], limits)
        if run_control:
            low = weights.reference_models(config, state, Numerics("float8"))
            t = time.perf_counter()
            ctrl = mod.answer(low, mix, group).permute(0, 2, 3, 1).contiguous()
            out["control_s"] = time.perf_counter() - t
            out["control"] = mod.numbers(models, mix, group, ctrl, followed)
            out["control_correct"] = harness.judge(out["control"], limits)
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    prog = [int(s) for s in args.program_seeds.split(",") if s]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in dict.fromkeys(prog + ctrl):
        line = json.dumps(readings(args.workload, seed, run_program=seed in prog,
                                   run_control=seed in ctrl))
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

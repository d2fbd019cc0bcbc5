"""One run of one cell: set-up, the measured window, the check, the line.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. Everything about a cell comes
from data found by name: the cell in ``BENCHMARK.json``, its configuration
``portbench/configs/<config>.json``, its traffic mix
``portbench/traffic/<traffic>.json``, its limits
``portbench/limits/<cell>.json``, and each per-layer metric's reader
``portbench/metrics/<metric>.py``.

A run:
1. set-up (``setup_s``, from process start): the kernels built if stale
   and loaded, the weights made on the device from the seed, the program's
   pipeline built from them, and one short group of the cell's shapes
   (the mix's ``warmup`` settings) run through the program;
2. the window: groups one after another, closed loop, each on fresh inputs
   (``traffic.py``) through ``program.dispatch`` and synchronised, the
   device's peak memory read after its first ``PEAK_GROUPS``; it closes
   at the end of the group during which ``--seconds`` passed (with
   ``--trace 1``: after the mix's ``trace_groups`` groups, or at
   ``--seconds`` if sooner, all of them under the profiler);
3. where the mix asks for them (``short_groups``), more groups through
   the program for their first steps; a check that no module of JAX or of
   the JAX package is loaded;
4. the program freed, the reference runs the groups drawn for the check
   and the short groups from their inputs and compares (``check``);
5. one JSON line on stdout: the end-to-end metrics (``--trace 0``) or the
   per-layer ones (``--trace 1``).
"""

from __future__ import annotations

import gc
import json
from contextlib import nullcontext
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
BANNED = ("jax", "jaxlib", "flax", "tpufusion")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, spec: dict = None):
    """``(spec, cell, config, mix, limits)`` of the cell named ``name``."""
    spec = spec or read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = read_json(HERE / "configs" / f"{cell['config']}.json")
    mix = read_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{name}.json")
    return spec, cell, config, mix, limits


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


@dataclass
class ReadContext:
    """What a per-layer reader reads (``metrics/__init__.py``)."""

    config: dict
    mix: dict
    trace: object
    steps: int
    _flops: float = None

    def group_flops(self) -> float:
        if self._flops is None:
            from portbench.flops import group_flops

            self._flops = group_flops(self.config, self.mix)
        return self._flops


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_program(config, seed, device):
    """The program's pipeline holding the weights of ``seed``."""
    from portbench import program, weights

    state = weights.make_state(config, seed, device)
    gen_ref = weights.reference_models(config, {"generator": state["generator"]})["generator"]
    mean = weights.mean_latent(gen_ref, seed, int(config["mean_latent_samples"]))
    return program.build_pipeline(config, state, mean, device)


def reference_group(config, mix, seed, index, device, models):
    """Group ``index``'s inputs as the reference gets them: the draws of
    ``run_window``'s (the images, the target and the attack's generator),
    and the mean latent of ``build_program``'s, from the float32 reference
    ``models``."""
    from portbench import traffic, weights
    from portbench.reference.attacks import Group

    n, size = int(config["n_inputs"]), int(config["generator"]["size"])
    images, target, gen = traffic.group_inputs(seed, index, n, size, mix["images"], device)
    mean = weights.mean_latent(models["generator"], seed, int(config["mean_latent_samples"]))
    return Group(images, target, max(size // int(config["encoder"]["input_size"]), 1), gen,
                 mean)


PEAK_GROUPS = 3  # the groups over which ``peak_mem_gib`` is read


def run_window(torch, pipeline, config, mix, seed, seconds, trace, device, cfg, keep):
    """The measured groups: ``(groups [(start, end)], window_s, kept
    outputs {index: host tensor}, trace or None, peak)``; ``keep`` maps the
    indices of the groups to keep to host buffers of the answer's shape.
    ``peak`` is the device's peak allocation over the window's first
    ``PEAK_GROUPS`` groups (all of them, where it holds fewer): a fixed
    amount of work, so that it does not follow how many groups a window
    holds (the program leaves memory behind a group, PERF.md section 2)."""
    from portbench import program, traffic
    from portbench import trace as tracing

    n, size = int(config["n_inputs"]), int(config["generator"]["size"])
    limit_groups = int(mix["trace_groups"]) if trace else math.inf
    prof = tracing.start() if trace else None
    groups, kept, peak = [], {}, None
    t0 = time.perf_counter()
    i = 0
    while True:
        images, target, gen = traffic.group_inputs(seed, i, n, size, mix["images"], device)
        span = torch.profiler.record_function(tracing.GROUP_SPAN) if trace else nullcontext()
        with span:
            s = time.perf_counter()
            adv = program.dispatch(pipeline, mix["attack"], images, target, cfg, gen)
            _sync(torch, device)
            e = time.perf_counter()
        groups.append((s, e))
        if i in keep:  # into pinned memory, queued behind the group's work
            kept[i] = keep[i].copy_(adv.detach(), non_blocking=True)
        del adv, images, target, gen
        i += 1
        if i == PEAK_GROUPS:
            peak = _peak(torch, device)
        if e - t0 >= seconds or i >= limit_groups:
            break
    window_s = groups[-1][1] - t0
    _sync(torch, device)
    parsed = tracing.stop(prof) if trace else None
    return groups, window_s, kept, parsed, _peak(torch, device) if peak is None else peak


def _peak(torch, device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def judge(nums: dict, limits: dict) -> bool:
    """Whether every number that ``limits`` holds is within its limit (a
    number that is missing, or has no limit, is not)."""
    return all(lim["limit"] is not None and nums.get(k, math.inf) <= lim["limit"]
               for k, lim in limits.items())


def short_groups(mix) -> dict:
    """``{index: name}`` of the short groups compared besides the window's:
    where a group's answer after all its steps cannot be followed step by
    step (an attack whose steps part any two runs that round differently),
    the mix's ``check.short`` names more groups of the same sizes through
    the same call, each with the runner's and the reference's settings for
    its first steps, run once the window has closed. Their numbers carry
    the group's name as a prefix (``first_step.sign_gap``)."""
    from portbench import traffic

    return {traffic.SHORT_GROUP - k: name
            for k, name in enumerate(mix["check"].get("short", {}))}


def group_mix(mix, index):
    """The mix as group ``index`` ran it: a short group with its runner's
    and reference's settings."""
    name = short_groups(mix).get(index)
    if name is None:
        return mix
    short = mix["check"]["short"][name]
    return {**mix, "run_config": {**mix["run_config"], **short["run_config"]},
            "reference": {**mix["reference"], **short["reference"]}}


def named(mix, index, nums: dict) -> dict:
    """Group ``index``'s numbers under the names the limits give them."""
    name = short_groups(mix).get(index)
    return nums if name is None else {f"{name}.{k}": v for k, v in nums.items()}


def short_answers(pipeline, config, mix, seed, device) -> dict:
    """The program's answers for the short groups, ``{index: host
    tensor}``."""
    from portbench import program, traffic

    n, size = int(config["n_inputs"]), int(config["generator"]["size"])
    out = {}
    for index in short_groups(mix):
        gmix = group_mix(mix, index)
        images, target, gen = traffic.group_inputs(seed, index, n, size, mix["images"], device)
        cfg = program.run_config(config, mix["attack"], gmix["run_config"])
        out[index] = program.dispatch(pipeline, mix["attack"], images, target, cfg,
                                      gen).detach().cpu()
    return out


def check(torch, config, mix, limits, seed, kept, device) -> dict:
    """The reference's run of each kept group, compared: ``{number: (worst
    value, limit)}`` and the count of groups that broke a limit (each held
    to the limits of the numbers it gives)."""
    from portbench import weights
    from portbench.reference import attacks
    from portbench.reference.numerics import Numerics, no_tf32

    with no_tf32():
        models = weights.reference_models(config, weights.make_state(config, seed, device),
                                          Numerics("float32"))
        mod = attacks.load(mix["attack"])
        worst, failed = {}, 0
        for i, adv in sorted(kept.items()):
            gmix = group_mix(mix, i)
            group = reference_group(config, gmix, seed, i, device, models)
            followed = mod.follow(models, gmix, group)
            nums = named(mix, i, mod.numbers(models, gmix, group, adv.to(device), followed))
            for k, v in nums.items():
                worst[k] = max(worst.get(k, -math.inf), v)
            failed += not judge(nums, {k: v for k, v in limits.items() if k in nums})
            print(f"portbench: group {i}: " + " ".join(f"{k} {v!r}" for k, v in nums.items()),
                  file=sys.stderr, flush=True)
        return worst, failed


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float = None, spec: dict = None, overrides: dict = None) -> dict:
    """One run; returns the result line's object. ``overrides`` replaces
    parts of the configuration and the mix (``{"config": {...}, "mix":
    {...}}``, the tests' small sizes on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from portbench import program, traffic

    spec, cell, config, mix, limits = load_cell(cell_name, spec)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("mix", {})}
    device = torch.device(device)
    on_card = device.type == "cuda"
    if trace and not on_card:
        raise ValueError("--trace 1 reads the card's profiler trace")
    marks = [("imports", time.perf_counter())]
    build_s = program.load_kernels() if on_card else 0.0
    marks.append(("kernels", time.perf_counter()))
    pipeline = build_program(config, seed, device)
    _sync(torch, device)
    marks.append(("weights and pipeline", time.perf_counter()))
    cfg = program.run_config(config, mix["attack"], mix["run_config"])
    warm = program.run_config(config, mix["attack"], {**mix["run_config"], **mix["warmup"]})
    n, size = int(config["n_inputs"]), int(config["generator"]["size"])
    images, target, gen = traffic.group_inputs(seed, traffic.WARMUP_GROUP, n, size,
                                               mix["images"], device)
    program.dispatch(pipeline, mix["attack"], images, target, warm, gen)
    _sync(torch, device)
    marks.append(("warm-up group", time.perf_counter()))
    del images, target, gen
    gc.collect()
    if on_card:
        # every window starts from the same allocator state: no cached block
        # left over from the set-up
        torch.cuda.empty_cache()
    power = card_power_limit() if on_card else "cpu"
    pool = int(mix["check"]["pool"])
    if trace:
        pool = min(pool, int(mix["trace_groups"]))
    keep = {i: torch.empty((n, size, size, 3), pin_memory=on_card)
            for i in traffic.checked_groups(seed, pool, int(mix["check"]["groups"]))}
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    last = t_start
    for what, t in marks:
        print(f"portbench: set-up {what} {t - last:.3f} s", file=sys.stderr)
        last = t

    groups, window_s, kept, parsed, peak_groups = run_window(
        torch, pipeline, config, mix, seed, seconds, trace, device, cfg, keep)
    peak = _peak(torch, device)
    kept.update(short_answers(pipeline, config, mix, seed, device))
    banned = banned_modules()
    if banned:
        print(f"portbench: modules loaded that must not be: {banned}", file=sys.stderr)
        raise SystemExit(3)
    del pipeline
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    missing = sorted(set(keep) - set(kept))
    t_check = time.perf_counter()
    worst, failed = check(torch, config, mix, limits, seed, kept, device)
    check_s = time.perf_counter() - t_check
    failed += len(missing)
    compared = {k: (worst.get(k, math.inf), v.get("limit")) for k, v in limits.items()}
    correct = not missing and all(lim is not None and val <= lim
                                  for val, lim in compared.values())

    steps = int(mix["steps"])
    result = dict(correct=correct, attempted=len(groups), failed=failed)
    if trace:
        from portbench import metrics
        from portbench import trace as tracing

        ctx = ReadContext(config, mix, parsed, steps)
        values = {}
        for m in spec["per_layer"]:
            if applies(m, cell_name):
                v = metrics.load(m["name"]).read(ctx)
                if v is not None:
                    values[m["name"]] = dict(value=v, unit=m["unit"])
        result["metrics"] = values
        busy = parsed.busy_s()
        result["device"] = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                                count=1, memory_peak_bytes=int(peak), busy_s=busy,
                                window_s=parsed.window_s, power_limit=power)
        result["breakdown"] = tracing.breakdown(parsed)
    else:
        e2e = dict(attack_step_ms=1e3 * window_s / (len(groups) * steps),
                   peak_mem_gib=peak_groups / 2 ** 30, setup_s=setup_s)
        result["metrics"] = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                             for m in spec["end_to_end"] if applies(m, cell_name)}
        result["device"] = dict(platform="gpu" if on_card else "cpu",
                                kind=torch.cuda.get_device_name(device) if on_card else "cpu",
                                count=1, memory_peak_bytes=int(peak), power_limit=power)
    # set-up includes the nvcc build of a checkout's first run; the line
    # says how much of it that was (0.0 when every library was there)
    result["build_s"] = build_s
    result["checked"] = {k: dict(value=v, limit=lim) for k, (v, lim) in compared.items()}
    ms = sorted(1e3 * (e - s) for s, e in groups)
    print(f"portbench: group ms min {ms[0]:.1f} median {statistics.median(ms):.1f} "
          f"max {ms[-1]:.1f}", file=sys.stderr)
    print(f"portbench: {cell_name} seed {seed}: {len(groups)} groups in {window_s:.3f} s, "
          f"set-up {setup_s:.3f} s (kernel build {build_s:.3f} s), check {check_s:.3f} s, "
          f"card {power}", file=sys.stderr)
    for k, (v, lim) in compared.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    return result


def main(argv=None, t_start: float = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec, cell, *_ = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start, spec=spec)
    print(json.dumps(result), flush=True)
    return 0

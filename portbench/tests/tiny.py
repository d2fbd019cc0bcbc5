"""Small sizes for the CPU tests: a 32^2 generator (512 channels a plane, as
the published table has below 64^2), a four-unit encoder of base width 16
whose last stage is as wide as the style (128), N = 2 (or the size that the
attack requires, ``n_inputs``), a few steps."""

from __future__ import annotations

import copy

import torch

from portbench import harness
from portbench.reference import attacks

CONFIG = {"n_inputs": 2, "compute_dtype": "float32", "mean_latent_samples": 64,
          "generator": {"size": 32, "style_dim": 128, "n_mlp": 2, "channel_multiplier": 1},
          "encoder": {"input_size": 32, "base_channels": 16, "unit_counts": [1, 1, 1, 1],
                      "n_styles": 8, "coarse_ind": 3, "middle_ind": 7}}


# the sizes at which the control and fault tests read a cell whose numbers
# are its first steps' (``check.short``): its float8 error grows with depth and width (the
# first step's sign_gap reads 0.03 at CONFIG, 0.08-0.09 here, 0.11-0.13 at
# 1024^2), so these take e4e's published depth and widths at 64^2
CONTROL_CONFIG = {**CONFIG,
                  "generator": {**CONFIG["generator"], "style_dim": 512, "size": 64},
                  "encoder": {**CONFIG["encoder"], "base_channels": 64, "input_size": 64,
                              "unit_counts": [3, 4, 14, 3], "n_styles": 10}}


def cells() -> list:
    """The benchmark's cells."""
    return [w["name"] for w in harness.read_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def n_inputs(config: dict, mix: dict) -> int:
    """N at the small sizes: what the mix's attack requires for ``config``
    where its reference module says (``n_inputs(config)``), 2 otherwise."""
    required = getattr(attacks.load(mix["attack"]), "n_inputs", None)
    return CONFIG["n_inputs"] if required is None else int(required(config))


def overrides(cell: str, steps: int = 3) -> dict:
    """The cell's configuration and mix at the small sizes, ``steps`` steps
    a group, the window's one group checked."""
    _, _, config, mix, _ = harness.load_cell(cell)
    return mix_overrides(config, mix, steps)


def mix_overrides(config: dict, mix: dict, steps: int = 3) -> dict:
    """``overrides`` of one configuration and traffic mix (the mix's
    warm-up settings name the runner's count of steps)."""
    rc = dict(mix["run_config"], **{k: steps for k in mix["warmup"]})
    ref = dict(mix["reference"], steps=steps)
    return {"config": {**copy.deepcopy(CONFIG), "n_inputs": n_inputs(config, mix)},
            "mix": {"run_config": rc, "reference": ref, "steps": steps,
                    "check": {**mix["check"], "groups": 1, "pool": 1}}}


def control_overrides(cell: str, steps: int = 3) -> dict:
    """``overrides`` for the control tests: ``CONTROL_CONFIG`` where the
    cell compares short groups, CONFIG otherwise (N as ``overrides``)."""
    ov = overrides(cell, steps)
    if "short" in ov["mix"]["check"]:
        ov["config"] = {**copy.deepcopy(CONTROL_CONFIG), "n_inputs": ov["config"]["n_inputs"]}
    return ov


def run(cell: str, seed: int = 2 ** 31 + 11, steps: int = 3) -> dict:
    """One CPU run of ``cell`` at the small sizes (``control_overrides``'):
    one group, checked."""
    torch.set_num_threads(4)
    return harness.run_cell(cell, seed, 0.0, False, device="cpu",
                            overrides=control_overrides(cell, steps))

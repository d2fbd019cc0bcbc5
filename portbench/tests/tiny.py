"""Small sizes for the CPU tests: a 32^2 generator (512 channels a plane, as
the published table has below 64^2), a four-unit encoder of base width 16
whose last stage is as wide as the style (128), N = 2, a few steps."""

from __future__ import annotations

import copy

import torch

from portbench import harness

CONFIG = {"n_inputs": 2, "compute_dtype": "float32", "mean_latent_samples": 64,
          "generator": {"size": 32, "style_dim": 128, "n_mlp": 2, "channel_multiplier": 1},
          "encoder": {"input_size": 32, "base_channels": 16, "unit_counts": [1, 1, 1, 1],
                      "n_styles": 8, "coarse_ind": 3, "middle_ind": 7}}


def cells() -> list:
    """The benchmark's cells."""
    return [w["name"] for w in harness.read_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def overrides(cell: str, steps: int = 3) -> dict:
    """The cell's configuration and mix at the small sizes, ``steps`` steps
    a group, the window's one group checked."""
    return mix_overrides(harness.load_cell(cell)[3], steps)


def mix_overrides(mix: dict, steps: int = 3) -> dict:
    """``overrides`` of one traffic mix."""
    rc = dict(mix["run_config"], n_iters=steps)
    ref = dict(mix["reference"], steps=steps)
    return {"config": copy.deepcopy(CONFIG),
            "mix": {"run_config": rc, "reference": ref, "steps": steps,
                    "check": {"groups": 1, "pool": 1}}}


def run(cell: str, seed: int = 2 ** 31 + 11, steps: int = 3) -> dict:
    """One CPU run of ``cell`` at the small sizes: one group, checked."""
    torch.set_num_threads(4)
    return harness.run_cell(cell, seed, 0.0, False, device="cpu",
                            overrides=overrides(cell, steps))

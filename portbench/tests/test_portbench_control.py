"""The control at a size a test run holds: the float8 reference in the
program's place reads far above the program, and the harness's own check
finds it not correct by the cell's committed limits.

``control.py`` takes the readings that each limit is set from on the card,
at the cell's own sizes (PERF.md gives them). Here the same code runs at
the small sizes on the CPU, where the program computes in float32 and reads
~0: the control's reading of every cell's main number stays well clear of
it, so a program that computed below the stated precision would show. A
cell that compares a first-step group reads it at larger small sizes
(``tiny.control_overrides``).
"""

import pytest
import torch

from portbench import control, harness, weights
from portbench.reference import attacks
from portbench.reference.numerics import Numerics
from portbench.tests import tiny


def _main(cell):
    """The cell's main compared number: the first in its limits."""
    return next(iter(harness.load_cell(cell)[4]))


@pytest.mark.parametrize("cell", tiny.cells())
def test_control_reads_far_above_the_program(cell):
    out = control.readings(cell, 2 ** 32 + 15, run_program=True, run_control=True,
                           device="cpu", overrides=tiny.control_overrides(cell, steps=10))
    prog, ctrl = out["program"][_main(cell)], out["control"][_main(cell)]
    assert prog <= 1e-3, out
    assert ctrl >= 0.02 and ctrl >= 10 * max(prog, 1e-4), out
    assert out["program_correct"] is True and out["control_correct"] is False, out


@pytest.mark.parametrize("cell", tiny.cells())
def test_control_in_the_programs_place_fails_the_check(cell):
    """The control's answers, handed to ``harness.check`` as the groups the
    cell compares (the window's, and the short groups where it compares
    them), with the cell's own limits: one group failed or more."""
    seed = 2 ** 32 + 29
    ov = tiny.control_overrides(cell, steps=10)
    _, _, config, mix, limits = harness.load_cell(cell)
    config, mix = {**config, **ov["config"]}, {**mix, **ov["mix"]}
    state = weights.make_state(config, seed, "cpu")
    low = weights.reference_models(config, state, Numerics("float8"))
    models = weights.reference_models(config, state)
    kept = {}
    for i in list(harness.short_groups(mix)) + [0]:
        gmix = harness.group_mix(mix, i)
        group = harness.reference_group(config, gmix, seed, i, "cpu", models)
        kept[i] = attacks.load(mix["attack"]).answer(low, gmix, group).permute(0, 2, 3, 1)
    worst, failed = harness.check(torch, config, mix, limits, seed,
                                  {i: a.contiguous() for i, a in kept.items()},
                                  torch.device("cpu"))
    assert 1 <= failed <= len(kept), worst
    assert not harness.judge(worst, limits), worst

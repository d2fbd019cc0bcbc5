"""``correct`` comes out false when the timed path is broken underneath.

Each case drives a whole run of a cell (the harness without its look for a
card, at the small sizes on the CPU) with the port broken in one way that
the cell can have, and sees the comparison fail. The faults are found by
the cell's attack (``tests/faults/<attack>.py``, whose docstrings list
them); a cell whose attack has none fails
``test_every_cells_attack_has_planted_faults``.

The exchange between chips does not exist in these one-chip cells. The
limits are the cells' own (``portbench/limits``).
"""

import pytest
import torch

from portbench import control, harness
from portbench.tests import faults, tiny

CELLS = tiny.cells()


def _attack(cell):
    return harness.load_cell(cell)[3]["attack"]


def _faults(cell) -> list:
    """The names of the cell's faults; none where its attack has no module
    (which ``test_every_cells_attack_has_planted_faults`` names)."""
    try:
        return sorted(faults.load(_attack(cell)))
    except faults.NoFaults:
        return []


CASES = [(cell, fault) for cell in CELLS for fault in _faults(cell)]


def test_every_cells_attack_has_planted_faults():
    missing = {cell: _attack(cell) for cell in CELLS if not _faults(cell)}
    assert not missing, f"no tests/faults/<attack>.py for these cells' attacks: {missing}"


def test_an_attack_without_faults_is_named():
    with pytest.raises(faults.NoFaults, match="'no_such_attack' has no planted faults"):
        faults.load("no_such_attack")


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    faults.load(_attack(cell))[fault](monkeypatch)
    out = tiny.run(cell)
    assert out["correct"] is False, out["checked"]
    # the window's group and each short group may break a limit
    mix = harness.load_cell(cell)[3]
    assert 1 <= out["failed"] <= 1 + len(harness.short_groups(mix)), out["checked"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    torch.manual_seed(0)
    out = tiny.run(cell)
    assert out["correct"] is True, out["checked"]


def test_control_reads_a_fault_through_the_registry(monkeypatch):
    """``control.readings(..., faults=[...])`` plants a fault that an
    attack's module gives, by its name, and reads it beside the program."""
    cell = "car512.whitebox"
    planted = []
    plants = faults.load(_attack(cell))
    plant = plants["double_rate"]

    def spy(mp):
        planted.append(True)
        plant(mp)

    monkeypatch.setitem(plants, "double_rate", spy)
    out = control.readings(cell, 2 ** 32 + 41, run_program=True, run_control=False,
                           faults=["double_rate"], device="cpu",
                           overrides=tiny.control_overrides(cell))
    assert planted == [True]
    assert out["program_correct"] is True and out["fault.double_rate_correct"] is False, out

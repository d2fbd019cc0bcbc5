"""``correct`` comes out false when the timed path is broken underneath.

Each case drives a whole run of a cell (the harness without its look for a
card, at the small sizes on the CPU) with the port broken in one way that
the cell can have, and sees the comparison fail:

- a step that returns its state unchanged (``StepProgram.run`` takes no
  step);
- half of the batch left out: the update gets a zero gradient for the
  second half of the images;
- an answer altered where it is produced: the update's step for image 0 is
  turned round;
- a step too long: Adam at twice the rate;
- Adam's bias correction dropped (its first steps some 3 to 5 times as
  long).

The exchange between chips does not exist in these one-chip cells. The
limits are the cells' own (``portbench/limits``).
"""

import pytest
import torch

import tpufusion_torch.attacks.whitebox as port_wb
from tpufusion_torch.core import graphs
from tpufusion_torch.ops import adam_update
from portbench.tests import tiny

CELLS = tiny.cells()


def _unchanged(monkeypatch):
    monkeypatch.setattr(graphs.StepProgram, "run", lambda self, n=1: None)


def _half_batch(monkeypatch):
    adam = port_wb.fused_adam

    def half(g):
        g = g.clone()
        g[g.shape[0] // 2:] = 0
        return g

    monkeypatch.setattr(port_wb, "fused_adam", lambda x, g, st, lr: adam(x, half(g), st, lr))


def _turned_round(monkeypatch):
    adam = port_wb.fused_adam

    def adam_wrong(x, g, st, lr):
        before = x[0].clone()
        x, st = adam(x, g, st, lr)
        x[0] = 2 * before - x[0]
        return x, st

    monkeypatch.setattr(port_wb, "fused_adam", adam_wrong)


def _double_rate(monkeypatch):
    adam = port_wb.fused_adam
    monkeypatch.setattr(port_wb, "fused_adam", lambda x, g, st, lr: adam(x, g, st, 2 * lr))


def _no_bias_correction(monkeypatch):
    table = adam_update.bias_table
    monkeypatch.setattr(adam_update, "bias_table", lambda device: torch.ones_like(table(device)))


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "turned_round": _turned_round,
          "double_rate": _double_rate, "no_bias_correction": _no_bias_correction}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = tiny.run(cell)
    assert out["correct"] is False, out["checked"]
    assert out["failed"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    torch.manual_seed(0)
    out = tiny.run(cell)
    assert out["correct"] is True, out["checked"]

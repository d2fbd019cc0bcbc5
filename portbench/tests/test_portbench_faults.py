"""``correct`` comes out false when the timed path is broken underneath.

Each case drives a whole run of a cell (the harness without its look for a
card, at the small sizes on the CPU) with the port broken in one way that
the cell can have, and sees the comparison fail. Every cell:

- a step that returns its state unchanged (``StepProgram.run`` takes no
  step).

The white-box cells (Adam on the pixels, ``fused_adam``):

- half of the batch left out: the update gets a zero gradient for the
  second half of the images;
- an answer altered where it is produced: the update's step for image 0 is
  turned round;
- a step too long: Adam at twice the rate;
- Adam's bias correction dropped (its first steps some 3 to 5 times as
  long).

The PGD cells (``pgd_update``, a random start drawn from the group's
generator):

- half of the batch left out: a zero gradient for the second half;
- an answer altered where it is produced: every step's sign turned round;
- the projection onto the eps-ball skipped;
- no random start: the steps start from the images;
- faults in every step of a group but its first, which on the card are the
  CUDA graph that the window replays (the first step runs eagerly): the
  state left unchanged, every sign turned round, and the first step's
  gradient used again.

The exchange between chips does not exist in these one-chip cells. The
limits are the cells' own (``portbench/limits``).
"""

import pytest
import torch

import tpufusion_torch.attacks.pgd as port_pgd
import tpufusion_torch.attacks.whitebox as port_wb
from tpufusion_torch.core import graphs
from tpufusion_torch.ops import adam_update
from portbench import harness
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


def _pgd_fault(monkeypatch, step):
    """``pgd_update`` called as ``step(update, adv, grad, images, alpha, eps,
    lo, hi)``."""
    update = port_pgd.pgd_update
    monkeypatch.setattr(port_pgd, "pgd_update",
                        lambda a, g, x, alpha, eps, lo=-1.0, hi=1.0:
                        step(update, a, g, x, alpha, eps, lo, hi))


def _pgd_half_batch(monkeypatch):
    def half(g):
        g = g.clone()
        g[g.shape[0] // 2:] = 0
        return g

    _pgd_fault(monkeypatch, lambda up, a, g, x, *rest: up(a, half(g), x, *rest))


def _pgd_sign_turned(monkeypatch):
    _pgd_fault(monkeypatch, lambda up, a, g, x, *rest: up(a, -g, x, *rest))


def _pgd_no_projection(monkeypatch):
    _pgd_fault(monkeypatch, lambda up, a, g, x, alpha, eps, lo, hi:
               up(a, g, x, alpha, float("inf"), lo, hi))


def _pgd_no_random_start(monkeypatch):
    monkeypatch.setattr(port_pgd, "pgd_random_start", lambda images, gen, cfg: images)


def _after_first_step(monkeypatch, fault):
    """``fault`` (a function of a monkeypatch) planted in every step of a
    program's run but its first: on the card the eager step is sound and
    the captured graph, and so every replay, is broken."""
    run = graphs.StepProgram.run

    def run_broken(self, n=1):
        run(self, 1)
        if n > 1:
            with pytest.MonkeyPatch.context() as mp:
                fault(mp)
                run(self, n - 1)

    monkeypatch.setattr(graphs.StepProgram, "run", run_broken)


def _replays_unchanged(monkeypatch):
    def still(mp):
        mp.setattr(port_pgd, "_update", lambda cfg, adv, images, loss_fn, loss_args:
                   (adv.detach().clone(), adv.new_zeros((), dtype=torch.float32)))

    _after_first_step(monkeypatch, still)


def _replays_sign_turned(monkeypatch):
    _after_first_step(monkeypatch, _pgd_sign_turned)


def _replays_stale(monkeypatch):
    """Every step after the first takes the first step's gradient."""
    first = {}
    update = port_pgd.pgd_update

    def remember(a, g, x, *rest):
        first["g"] = g.clone()
        return update(a, g, x, *rest)

    def stale(mp):
        mp.setattr(port_pgd, "pgd_update", lambda a, g, x, *rest: update(a, first["g"], x, *rest))

    monkeypatch.setattr(port_pgd, "pgd_update", remember)
    _after_first_step(monkeypatch, stale)


FAULTS = {
    "white_box_target": {"unchanged": _unchanged, "half_batch": _half_batch,
                         "turned_round": _turned_round, "double_rate": _double_rate,
                         "no_bias_correction": _no_bias_correction},
    "fusion_pgd_arith": {"unchanged": _unchanged, "half_batch": _pgd_half_batch,
                         "sign_turned": _pgd_sign_turned, "no_projection": _pgd_no_projection,
                         "no_random_start": _pgd_no_random_start,
                         "replays_unchanged": _replays_unchanged,
                         "replays_sign_turned": _replays_sign_turned,
                         "replays_stale": _replays_stale},
}
CASES = [(cell, fault) for cell in CELLS
         for fault in sorted(FAULTS[harness.load_cell(cell)[3]["attack"]])]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    FAULTS[harness.load_cell(cell)[3]["attack"]][fault](monkeypatch)
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

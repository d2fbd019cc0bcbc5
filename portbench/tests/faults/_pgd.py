"""Plants of the PGD loop (``attacks/pgd.py``: ``pgd_update``, a random
start drawn from the group's generator), which every fusion of the fusion
PGD shares:

- a step that returns its state unchanged;
- half of the batch left out: a zero gradient for the second half;
- an answer altered where it is produced: every step's sign turned round;
- the projection onto the eps-ball skipped;
- no random start: the steps start from the images;
- faults in every step of a group but its first, which on the card are the
  CUDA graph that the window replays (the first step runs eagerly): the
  state left unchanged, every sign turned round, and the first step's
  gradient used again.

``FAULTS`` holds them all; an attack's module takes it and adds its own.
"""

from __future__ import annotations

import torch

import tpufusion_torch.attacks.pgd as port_pgd
from portbench.tests.faults._steps import after_first_step, unchanged


def _pgd_fault(monkeypatch, step):
    """``pgd_update`` called as ``step(update, adv, grad, images, alpha, eps,
    lo, hi)``."""
    update = port_pgd.pgd_update
    monkeypatch.setattr(port_pgd, "pgd_update",
                        lambda a, g, x, alpha, eps, lo=-1.0, hi=1.0:
                        step(update, a, g, x, alpha, eps, lo, hi))


def half_batch(monkeypatch):
    def half(g):
        g = g.clone()
        g[g.shape[0] // 2:] = 0
        return g

    _pgd_fault(monkeypatch, lambda up, a, g, x, *rest: up(a, half(g), x, *rest))


def sign_turned(monkeypatch):
    _pgd_fault(monkeypatch, lambda up, a, g, x, *rest: up(a, -g, x, *rest))


def no_projection(monkeypatch):
    _pgd_fault(monkeypatch, lambda up, a, g, x, alpha, eps, lo, hi:
               up(a, g, x, alpha, float("inf"), lo, hi))


def no_random_start(monkeypatch):
    monkeypatch.setattr(port_pgd, "pgd_random_start", lambda images, gen, cfg: images)


def replays_unchanged(monkeypatch):
    def still(mp):
        mp.setattr(port_pgd, "_update", lambda cfg, adv, images, loss_fn, loss_args:
                   (adv.detach().clone(), adv.new_zeros((), dtype=torch.float32)))

    after_first_step(monkeypatch, still)


def replays_sign_turned(monkeypatch):
    after_first_step(monkeypatch, sign_turned)


def replays_stale(monkeypatch):
    """Every step after the first takes the first step's gradient."""
    first = {}
    update = port_pgd.pgd_update

    def remember(a, g, x, *rest):
        first["g"] = g.clone()
        return update(a, g, x, *rest)

    def stale(mp):
        mp.setattr(port_pgd, "pgd_update", lambda a, g, x, *rest: update(a, first["g"], x, *rest))

    monkeypatch.setattr(port_pgd, "pgd_update", remember)
    after_first_step(monkeypatch, stale)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "sign_turned": sign_turned,
          "no_projection": no_projection, "no_random_start": no_random_start,
          "replays_unchanged": replays_unchanged, "replays_sign_turned": replays_sign_turned,
          "replays_stale": replays_stale}

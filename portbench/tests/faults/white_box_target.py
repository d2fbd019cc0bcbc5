"""Faults of the white-box target attack (Adam on the pixels, the
``fused_adam`` kernel):

- a step that returns its state unchanged;
- half of the batch left out: the update gets a zero gradient for the
  second half of the images;
- an answer altered where it is produced: the update's step for image 0 is
  turned round;
- a step too long: Adam at twice the rate;
- Adam's bias correction dropped (its first steps some 3 to 5 times as
  long).
"""

from __future__ import annotations

import torch

import tpufusion_torch.attacks.whitebox as port_wb
from tpufusion_torch.ops import adam_update
from portbench.tests.faults._steps import unchanged


def half_batch(monkeypatch):
    adam = port_wb.fused_adam

    def half(g):
        g = g.clone()
        g[g.shape[0] // 2:] = 0
        return g

    monkeypatch.setattr(port_wb, "fused_adam", lambda x, g, st, lr: adam(x, half(g), st, lr))


def turned_round(monkeypatch):
    adam = port_wb.fused_adam

    def adam_wrong(x, g, st, lr):
        before = x[0].clone()
        x, st = adam(x, g, st, lr)
        x[0] = 2 * before - x[0]
        return x, st

    monkeypatch.setattr(port_wb, "fused_adam", adam_wrong)


def double_rate(monkeypatch):
    adam = port_wb.fused_adam
    monkeypatch.setattr(port_wb, "fused_adam", lambda x, g, st, lr: adam(x, g, st, 2 * lr))


def no_bias_correction(monkeypatch):
    table = adam_update.bias_table
    monkeypatch.setattr(adam_update, "bias_table", lambda device: torch.ones_like(table(device)))


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "turned_round": turned_round,
          "double_rate": double_rate, "no_bias_correction": no_bias_correction}

"""The operations one group computes, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the products
(convolutions, matrix products) of the reference's run of one group on
the ``meta`` device: shapes only, no memory, no device. A group is the
attack's one-off work (``once``: the no-grad bundle) plus ``steps`` times
one step (the forward and the gradient to the pixels; the weights are
frozen, so no weight gradients). The count is of the work the attack needs
for its answer, the same whatever the program runs it with; elementwise
work is not counted.
"""

from __future__ import annotations

import torch

from portbench import weights
from portbench.reference import attacks
from portbench.reference.attacks import Group


def group_flops(config: dict, mix: dict) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    models = weights.reference_modules(config)
    for m in models.values():
        m.requires_grad_(False).eval()
    n, size = int(config["n_inputs"]), int(config["generator"]["size"])
    group = Group(images=torch.zeros(n, size, size, 3, device="meta"),
                  target=torch.zeros(1, size, size, 3, device="meta"),
                  pool_factor=max(size // int(config["encoder"]["input_size"]), 1),
                  latent_avg=torch.zeros(1, int(config["generator"]["style_dim"]),
                                         device="meta"))
    once, step = attacks.load(mix["attack"]).flop_parts(models, mix, group)
    counts = []
    for fn in (once, step):
        with FlopCounterMode(display=False) as fc:
            fn()
        counts.append(fc.get_total_flops())
    return float(counts[0] + int(mix["steps"]) * counts[1])

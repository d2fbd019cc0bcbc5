"""Plain reference loops of the attacks, one module per attack name.

Each module ``<attack>.py`` (the runner's attack name) gives:

- ``answer(models, mix, group)``: the attack run by the reference models on
  one group, the adversarial batch (NCHW); with the float8 models it is the
  control that ``control.py`` puts in the program's place;
- ``follow(models, mix, group) -> dict``: what the comparison needs from
  the reference for that group (its answer, where the attack can be
  followed);
- ``numbers(models, mix, group, adv, followed) -> dict``: the numbers
  compared on the program's adversarial batch ``adv`` (NHWC), by name;
- ``flop_parts(models, mix, group) -> (once, step)``: two callables whose
  products ``flops.py`` counts: the work a group does once and the work of
  one step (its gradient by ``backward()``: the counter cannot follow
  ``autograd.grad`` into a module whose input is a leaf).

and, where the attack requires a group of a size of its own:

- ``n_inputs(config) -> int``: that size for the configuration ``config``
  (a spatial fusion's is the count of its dataset's roles). The CPU tests'
  small sizes (``tests/tiny.py``) take it in place of their N = 2; no run
  reads it, since a configuration's own ``n_inputs`` holds at full size.

``models`` are ``weights.reference_models``; ``mix`` is the traffic mix;
``group`` a ``Group``. A later attack adds a module here, and its planted
faults in ``tests/faults/<attack>.py``; nothing else changes.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass
class Group:
    """One group's inputs, NHWC float32 as the program gets them: the
    images, the target, the generator that the runner hands the attack for
    what it draws (in the state the program gets it), and the mean latent
    that the program's pipeline holds."""

    images: torch.Tensor  # (N, S, S, 3)
    target: torch.Tensor  # (1, S, S, 3)
    pool_factor: int
    generator: torch.Generator = None
    latent_avg: torch.Tensor = None  # (1, style_dim)

    def draws(self) -> torch.Generator:
        """A generator in the state of ``generator``: what the attack draws
        from it, drawn again as often as a reference needs."""
        gen = torch.Generator(device=self.generator.device)
        gen.set_state(self.generator.get_state())
        return gen


def load(attack: str):
    return importlib.import_module(f"portbench.reference.attacks.{attack}")


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def mse(a, b):
    """Per-image mean squared difference, (B,)."""
    d = a - b
    return (d * d).flatten(1).mean(dim=1)


def chunks(n: int, size: int):
    size = max(int(size), 1)
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]

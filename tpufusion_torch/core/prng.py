"""Deterministic random streams (port of ``tpufusion/core/prng.py``).

The reference pins global seeds (`attack_main2.py:39-44`, seed 123456789).
The JAX package splits one root key per consumer; here ``PRNGPool`` hands out
fresh ``torch.Generator``s, each seeded from one root stream, so a pool's
sequence of generators depends only on its seed. The draws themselves are
PyTorch's, not JAX's threefry: the same seed gives other numbers than in the
JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpufusion_torch.core.dtypes import resolve_device

GLOBAL_SEED = 123456789  # mirrors reference setup_seed(123456789)

_PHI_MINUS_2 = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))


def truncated_normal(shape, std: float, device=None, generator=None) -> torch.Tensor:
    """A normal of scale ``std`` truncated at two scales, as flax draws its
    ``truncated_normal`` initialisers: the standard normal restricted to
    [-2, 2] by inverting its CDF on a uniform draw from ``generator``, times
    ``std``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = (2 * _PHI_MINUS_2 - 1) + u * (2 - 4 * _PHI_MINUS_2)
    return (torch.erfinv(u) * (std * math.sqrt(2.0))).clamp(-2 * std, 2 * std)


class PRNGPool:
    """Imperative stream of ``torch.Generator``s on ``device`` (``cuda``
    unless given) for the host code that runs the attacks."""

    def __init__(self, seed: int = GLOBAL_SEED, device=None):
        self.device = resolve_device(device)
        self._root = torch.Generator().manual_seed(seed)

    def next(self) -> torch.Generator:
        return self.next_n(1)[0]

    def next_n(self, n: int) -> list:
        seeds = torch.randint(0, 2 ** 62, (n,), generator=self._root).tolist()
        return [torch.Generator(device=self.device).manual_seed(s) for s in seeds]


def seed_everything(seed: int = GLOBAL_SEED, device=None) -> PRNGPool:
    """Seed numpy (host-side shuffles) and torch's default generators, and
    return a pool of generators on ``device``."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return PRNGPool(seed, device)

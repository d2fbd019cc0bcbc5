"""PGD / FGSM (port of ``tpufusion/attacks/pgd.py``).

Random start in the eps-ball, ``adv += alpha * sign(grad)``, delta clamped to
+-eps, pixels clamped to the valid range; 1 step == FGSM. Generic over any
differentiable scalar loss. The step loop is a Python loop; the update is
the fused ``ops.pgd_update`` kernel on the card. The loss trace stays on the
device: nothing in the loop waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from tpufusion_torch.ops.pgd_update import pgd_update


@dataclasses.dataclass(frozen=True)
class PGDConfig:
    """eps=8/255, alpha=0.01 mirror the reference recipe; in [-1, 1] pixel
    space the range is 2x wider, so eps doubles when reproducing [0, 1]."""

    eps: float = 8.0 / 255.0
    alpha: float = 0.01
    steps: int = 40
    random_start: bool = True
    targeted: bool = False
    clip_min: float = -1.0
    clip_max: float = 1.0


def make_pgd(loss_fn: Callable, config: PGDConfig, *, external_start: bool = False):
    """Build a PGD attack.

    ``loss_fn(adv_images, *loss_args) -> scalar``; untargeted attacks ascend
    it, targeted attacks descend it. Returns
    ``attack(images, generator, *loss_args) -> (adv_images, loss_trace)``
    where ``generator`` (a ``torch.Generator``) draws the random start, or,
    with ``external_start=True``, ``attack(images, start, *loss_args)``.
    """
    cfg = config
    sign = -1.0 if cfg.targeted else 1.0

    def loop(images, adv, loss_args):
        trace = []
        for _ in range(cfg.steps):
            adv = adv.detach().requires_grad_(True)
            loss = sign * loss_fn(adv, *loss_args)
            (g,) = torch.autograd.grad(loss, adv)
            # ascend: pgd_update adds alpha*sign(grad) of `sign*loss`; a
            # gradient through a channels-first op (the classifiers' resize)
            # can come back strided, and the kernel reads contiguous memory
            adv = pgd_update(adv.detach(), g.contiguous(), images, cfg.alpha, cfg.eps,
                             cfg.clip_min, cfg.clip_max)
            trace.append(sign * loss.detach())
        return adv, torch.stack(trace)

    if external_start:
        def attack_ext(images, start, *loss_args):
            return loop(images, start, loss_args)
        return attack_ext

    def attack(images, generator: Optional[torch.Generator] = None, *loss_args):
        return loop(images, pgd_random_start(images, generator, cfg), loss_args)

    return attack


def pgd_random_start(images, generator: Optional[torch.Generator], config: PGDConfig):
    """Uniform start in the eps-ball around ``images``, clamped to the range."""
    if not config.random_start:
        return images
    u = torch.rand(images.shape, generator=generator, device=images.device,
                   dtype=images.dtype)
    noise = u * (2 * config.eps) - config.eps
    return (images + noise).clamp(config.clip_min, config.clip_max)


def fgsm(loss_fn: Callable, eps: float, *, targeted: bool = False,
         clip_min: float = -1.0, clip_max: float = 1.0):
    """Single-step PGD without random start == FGSM."""
    cfg = PGDConfig(eps=eps, alpha=eps, steps=1, random_start=False, targeted=targeted,
                    clip_min=clip_min, clip_max=clip_max)
    return make_pgd(loss_fn, cfg)

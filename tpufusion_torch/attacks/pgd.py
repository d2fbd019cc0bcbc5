"""PGD / FGSM (port of ``tpufusion/attacks/pgd.py``).

Random start in the eps-ball, ``adv += alpha * sign(grad)``, delta clamped to
+-eps, pixels clamped to the valid range; 1 step == FGSM. Generic over any
differentiable scalar loss. The update is the fused ``ops.pgd_update``
kernel on the card.

The JAX package runs the whole ``steps`` loop as one ``lax.scan`` inside one
``jit``; here one step is a ``core.graphs.StepProgram`` over static
buffers (``adv``, a float32 (steps,) loss trace and a device step index):
on the card its first step runs eagerly, the step is then captured once as
a CUDA graph and every later step replays it, with nothing read on the host
in between. The program is cached on the attack, keyed by the inputs'
shapes, dtypes and device and the identity of the non-tensor loss
arguments: a second call copies its inputs into the static buffers and
only replays. The random start is drawn outside the program, by the
caller's generator. ``pgd_eager``, the Python loop, is the program's plain
twin.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from tpufusion_torch.core.graphs import (
    ProgramCache, StepProgram, signature, split_args, static_copy)
from tpufusion_torch.core.trace import span
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


def _update(cfg: PGDConfig, adv, images, loss_fn, loss_args):
    """One step from ``adv``: ``(new adv, loss)``. Ascend: pgd_update adds
    alpha*sign(grad) of ``sign*loss``; a gradient through a channels-first
    op (the classifiers' resize) can come back strided, and the kernel reads
    contiguous memory."""
    sign = -1.0 if cfg.targeted else 1.0
    adv = adv.detach().requires_grad_(True)
    loss = sign * loss_fn(adv, *loss_args)
    (g,) = torch.autograd.grad(loss, adv)
    new = pgd_update(adv.detach(), g.contiguous(), images, cfg.alpha, cfg.eps,
                     cfg.clip_min, cfg.clip_max)
    return new, (sign * loss.detach()).float()


def pgd_eager(loss_fn: Callable, config: PGDConfig, images, start, *loss_args):
    """The plain twin of the PGD program: the step loop in Python, each
    step's tensors new. Returns ``(adv, trace)``, the trace float32."""
    adv, trace = start, []
    for _ in range(config.steps):
        adv, loss = _update(config, adv, images, loss_fn, loss_args)
        trace.append(loss)
    return adv, torch.stack(trace)


def pgd_program(loss_fn: Callable, config: PGDConfig, images, start, loss_args) -> StepProgram:
    """The PGD step over static buffers: state ``adv`` (from ``start``),
    ``trace`` and ``idx``; inputs ``images`` and the tensor loss arguments
    (the others are fixed here)."""
    cfg = config
    _, rebuild = split_args(loss_args)

    def body(state, inputs):
        new, loss = _update(cfg, state["adv"], inputs["images"], loss_fn,
                            rebuild(inputs["args"]))
        state["adv"].copy_(new)
        state["trace"].index_copy_(0, state["idx"].view(1), loss.view(1))
        state["idx"].add_(1)

    state, inputs = _pgd_buffers(cfg, images, start, loss_args)
    return StepProgram(body, static_copy(state), static_copy(inputs), limit=cfg.steps)


def _pgd_buffers(cfg, images, start, loss_args):
    """A call's starting state and inputs, in the program's structure."""
    # the trace in the loss's ``.float()`` dtype
    state = dict(adv=start, trace=torch.zeros(cfg.steps, device=images.device).float(),
                 idx=torch.zeros((), dtype=torch.int64, device=images.device))
    inputs = dict(images=images, args=split_args(loss_args)[0])
    return state, inputs


def make_pgd(loss_fn: Callable, config: PGDConfig, *, external_start: bool = False,
             fixed=()):
    """Build a PGD attack.

    ``loss_fn(adv_images, *loss_args) -> scalar``; untargeted attacks ascend
    it, targeted attacks descend it. Returns
    ``attack(images, generator, *loss_args) -> (adv_images, loss_trace)``
    where ``generator`` (a ``torch.Generator``) draws the random start, or,
    with ``external_start=True``, ``attack(images, start, *loss_args)``.
    The trace is float32. ``fixed`` names what ``loss_fn`` reads besides its
    arguments (a pipeline): a captured step holds its tensors' addresses,
    so the program is rebuilt when they move. ``attack.programs`` holds the
    attack's step programs (``release()`` frees them).
    """
    cfg = config
    programs = ProgramCache(fixed)

    def run(images, start, loss_args):
        with span("attack.prepare"):
            key = signature(images, start, *loss_args)
            prog = programs.get(key, lambda: pgd_program(loss_fn, cfg, images, start, loss_args),
                                keep=loss_args)
            prog.load(*_pgd_buffers(cfg, images, start, loss_args))
        prog.run(cfg.steps)
        return prog.state["adv"].clone(), prog.state["trace"].clone()

    if external_start:
        def attack_ext(images, start, *loss_args):
            return run(images, start, loss_args)
        attack_ext.programs = programs
        return attack_ext

    def attack(images, generator: Optional[torch.Generator] = None, *loss_args):
        return run(images, pgd_random_start(images, generator, cfg), loss_args)

    attack.programs = programs
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

"""Carlini-Wagner L2 attack (port of ``tpufusion/attacks/cw.py``; the
reference's inline copy is `interpolation.py:98-193`).

tanh-space Adam with best-L2 tracking: optimise w where
``adv = tanh(w) * scale + shift`` (the image range), cost =
``sum(L2(adv, img)) + c * sum(f(logits))``, f the margin hinge on the
logits. The loop runs the full budget and keeps each image's best iterate:
one whose margin is met (``f <= 0``) at a strictly lower L2 than the best so
far. The Adam step on w is ``ops.adam_update.fused_adam`` (the kernel on the
card); the best iterate is kept on the device with ``torch.where``, so
nothing in the loop waits for the host.

The JAX package runs the loop as one ``lax.scan``; here one step is a
``core.graphs.StepProgram`` over static buffers (``w``, the Adam moments and
its device step count, ``best_adv``, ``best_l2``), run on the card as
``attacks/pgd.py`` describes: the first step eagerly, the rest as replays of
the step captured once, the program cached on the attack. ``cw_eager``, the Python loop, is its plain
twin.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from tpufusion_torch.core.graphs import (
    ProgramCache, StepProgram, signature, split_args, static_copy)
from tpufusion_torch.core.trace import span
from tpufusion_torch.ops.adam_update import adam_init, fused_adam


@dataclasses.dataclass(frozen=True)
class CWConfig:
    c: float = 1e-4
    kappa: float = 0.0
    steps: int = 200  # reference recipe uses CW(model, steps=200) (`:1357`)
    lr: float = 0.01
    targeted: bool = False
    clip_min: float = -1.0
    clip_max: float = 1.0


def _cw_parts(config: CWConfig):
    """``(to_tanh_space, step)``: ``step(images, labels, state, logits_fn,
    logits_args)`` updates ``state`` (``w``, ``opt``, ``best_adv``,
    ``best_l2``) in place and returns it."""
    cfg = config
    lo, hi = cfg.clip_min, cfg.clip_max
    scale, shift = (hi - lo) / 2.0, (hi + lo) / 2.0

    def to_tanh_space(x):
        return torch.atanh(((x - shift) / scale).clamp(-1 + 1e-6, 1 - 1e-6))

    def from_tanh_space(w):
        return torch.tanh(w) * scale + shift

    def margin(logits, labels):
        one_hot = F.one_hot(labels.long(), logits.shape[-1]).float()
        real = (one_hot * logits).sum(dim=-1)  # true/target-class logit
        other = ((1 - one_hot) * logits - one_hot * 1e9).amax(dim=-1)
        return (other - real if cfg.targeted else real - other).clamp_min(-cfg.kappa)

    def step(images, labels, state, logits_fn, logits_args):
        dims = tuple(range(1, images.ndim))
        w = state["w"]
        wr = w.detach().requires_grad_(True)
        adv = from_tanh_space(wr)
        l2 = ((adv - images) ** 2).sum(dim=dims)
        # the logits of the cost's own forward decide success: a second
        # forward would cost a third more a step
        f = margin(logits_fn(adv, *logits_args).float(), labels)
        (g,) = torch.autograd.grad(l2.sum() + cfg.c * f.sum(), wr)
        _, state["opt"] = fused_adam(w, g.contiguous(), state["opt"], cfg.lr)
        better = (f.detach() <= 0) & (l2.detach() < state["best_l2"])
        state["best_adv"].copy_(torch.where(better.view((-1,) + (1,) * len(dims)),
                                            adv.detach(), state["best_adv"]))
        state["best_l2"].copy_(torch.where(better, l2.detach(), state["best_l2"]))
        return state

    return to_tanh_space, step


def _cw_start(to_tanh_space, images, *, on_device: bool):
    w = to_tanh_space(images).contiguous()
    return dict(w=w, opt=adam_init(w, on_device=on_device), best_adv=images.clone(),
                best_l2=torch.full((images.shape[0],), float("inf"), dtype=images.dtype,
                                   device=images.device))


def cw_eager(logits_fn: Callable, config: CWConfig, images, labels, *logits_args):
    """The plain twin of the CW program: the step loop in Python, the Adam
    count on the host. Returns ``(best_adv, best_l2)``."""
    to_tanh_space, step = _cw_parts(config)
    images = images.float()
    state = _cw_start(to_tanh_space, images, on_device=False)
    for _ in range(config.steps):
        state = step(images, labels, state, logits_fn, logits_args)
    return state["best_adv"], state["best_l2"]


def make_cw(logits_fn: Callable, config: CWConfig):
    """Build a CW-L2 attack against ``logits_fn(images, *logits_args) ->
    (B, K)``.

    Returns ``attack(images, labels, *logits_args) -> (best_adv, best_l2)``;
    ``labels`` are true labels (untargeted) or target labels (targeted).
    ``best_l2`` is ``inf`` and ``best_adv`` the input image where no
    iterate met the margin. The classifier adapters take ``(model,
    images)``: wrap as ``make_cw(lambda x, m: logits_fn(m, x), cfg)`` and
    call with ``(images, labels, model)``. ``attack.programs`` holds the
    attack's step programs (``release()`` frees them).
    """
    cfg = config
    to_tanh_space, step = _cw_parts(cfg)
    programs = ProgramCache()

    def build(images, labels, logits_args):
        _, rebuild = split_args(logits_args)

        def body(state, inputs):
            step(inputs["images"], inputs["labels"], state, logits_fn, rebuild(inputs["args"]))

        state, inputs = buffers(images, labels, logits_args)
        return StepProgram(body, static_copy(state), static_copy(inputs), limit=cfg.steps)

    def buffers(images, labels, logits_args):
        return (_cw_start(to_tanh_space, images, on_device=True),
                dict(images=images, labels=labels, args=split_args(logits_args)[0]))

    def attack(images, labels, *logits_args):
        with span("attack.prepare"):
            images = images.float()
            key = signature(images, labels, *logits_args)
            prog = programs.get(key, lambda: build(images, labels, logits_args),
                                keep=logits_args)
            prog.load(*buffers(images, labels, logits_args))
        prog.run(cfg.steps)
        return prog.state["best_adv"].clone(), prog.state["best_l2"].clone()

    attack.programs = programs
    return attack

"""Fusion-aware PGD with arithmetic fusion (the paper's fusion attack,
BASELINE config 2; the runner's ``fusion_pgd_arith``): targeted L-inf PGD
on all N images at once, pulling their fused image toward the target.

The fused image of N images is StyleGAN2's image of the mean of their
codes: e4e's codes of each pooled image plus the mean latent, averaged
over the N. One step from ``adv``:

    g    = d/d adv  mean((fused(adv) - target)^2)
    adv' = clip(x + clip(adv - alpha * sign(g) - x, -eps, eps), -1, 1)

from a random start uniform in the eps-ball around the images ``x``,
clamped to [-1, 1], drawn from the group's generator as the program draws
it (``torch.rand`` of the images' shape, NHWC). The mix's ``reference``
gives ``eps``, ``alpha`` and ``steps`` (the runner's ``pgd_eps`` and
``pgd_alpha`` doubled for the [-1, 1] range).

The loop takes the fused-image function as an argument (``attack``,
``follow_fused``, ``numbers_fused``, ``flop_parts_fused``), so that another
fusion of the same attack brings only its own function.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.attacks import mse, nchw
from portbench.reference.models import avg_pool


def fused_image(models, group):
    """``fused(x)``: the (1, 3, S, S) image of the mean of the codes of the
    (N, 3, S, S) images ``x``."""
    enc, gen = models["encoder"], models["generator"]

    def fused(x):
        codes = enc(avg_pool(x, group.pool_factor)) + group.latent_avg
        return gen(codes[:, :gen.n_latent].mean(dim=0, keepdim=True))

    return fused


def random_start(group, eps):
    """The program's random start (NCHW): uniform in the eps-ball around the
    images, clamped to [-1, 1]."""
    x = group.images
    u = torch.rand(x.shape, generator=group.draws(), device=x.device, dtype=x.dtype)
    return nchw((x + (u * (2 * eps) - eps)).clamp(-1.0, 1.0))


def _loss(fused, x, target):
    return mse(fused(x), target).sum()


def run(fused, mix, group):
    """The PGD loop under the fused-image function ``fused``: its random
    start, the gradient there (the first step's) and its answer, NCHW."""
    p = mix["reference"]
    x, target = nchw(group.images), nchw(group.target)
    eps, alpha = float(p["eps"]), float(p["alpha"])
    start = adv = random_start(group, eps)
    first = None
    for _ in range(int(p["steps"])):
        a = adv.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_loss(fused, a, target), a)
        first = g if first is None else first
        delta = (adv + alpha * torch.sign(-g) - x).clamp(-eps, eps)
        adv = (x + delta).clamp(-1.0, 1.0)
    return start, first, adv.detach()


def attack(fused, mix, group):
    """The PGD answer (NCHW) under the fused-image function ``fused``."""
    return run(fused, mix, group)[2]


def follow_fused(fused, mix, group):
    """The reference's answer (NCHW), its random start and the magnitude of
    its first gradient there, and its loss at its answer."""
    start, first, adv = run(fused, mix, group)
    with torch.no_grad():
        return dict(adv=adv, start=start, weight=first.abs(),
                    loss_end=float(_loss(fused, adv, nchw(group.target))))


def numbers_fused(fused, mix, group, adv, followed):
    """The numbers read between the program's answer ``adv`` (NHWC) and the
    reference's:

    - ``sign_gap``: the share of the pixels whose move from the random
      start goes another way than the reference's (up, down or not at all),
      each pixel weighted by the magnitude of the reference's first
      gradient at it. After one step it is the share of the first
      gradient's signs that the program got wrong, by how much each
      matters: 0 where every sign agrees, 1/2 where they are a coin's, 1
      where every one is turned;
    - ``linf_excess``: how far the answer leaves the set that every step
      projects onto, the eps-ball around the images and [-1, 1]: the larger
      of ``max |adv - x| - eps`` and ``max |adv| - 1``, in float64. A sound
      answer reads no more than the rounding of one float32 sum;
    - ``loss_excess``: how far the reference's loss at the program's
      answer lies above its loss at its own, over the latter: about 0
      where both descended alike (the loss swings by some tens of percent
      from step to step at the end), far above 1 where the program's steps
      went astray (turned round, or on a stale gradient);
    - ``delta_gap``: the distance between the two perturbations over the
      reference's.

    Which are compared, and for which group, the cell's limits say."""
    p = mix["reference"]
    x, target, prog = nchw(group.images), nchw(group.target), nchw(adv.float())
    if not bool(torch.isfinite(prog).all()):
        return dict(sign_gap=math.inf, linf_excess=math.inf, loss_excess=math.inf,
                    delta_gap=math.inf)
    with torch.no_grad():
        loss_prog = float(_loss(fused, prog, target))
    start, weight = followed["start"], followed["weight"]
    turned = torch.sign(prog - start) != torch.sign(followed["adv"] - start)
    d_prog, d_ref = (prog - x).flatten(), (followed["adv"] - x).flatten()
    excess = max(float((prog.double() - x.double()).abs().max()) - float(p["eps"]),
                 float(prog.double().abs().max()) - 1.0)
    return dict(sign_gap=float((weight.double() * turned).sum() / weight.double().sum()),
                linf_excess=excess,
                loss_excess=(loss_prog - followed["loss_end"]) / max(followed["loss_end"], 1e-30),
                delta_gap=float((d_prog - d_ref).norm() / d_ref.norm().clamp_min(1e-30)))


def flop_parts_fused(fused, mix, group):
    """No work once; a step is the fused image's loss and its gradient to
    the pixels."""
    x, target = nchw(group.images), nchw(group.target)

    def step():
        _loss(fused, x.detach().requires_grad_(True), target).backward()

    return (lambda: None), step


def answer(models, mix, group):
    return attack(fused_image(models, group), mix, group)


def follow(models, mix, group):
    return follow_fused(fused_image(models, group), mix, group)


def numbers(models, mix, group, adv, followed):
    return numbers_fused(fused_image(models, group), mix, group, adv, followed)


def flop_parts(models, mix, group):
    return flop_parts_fused(fused_image(models, group), mix, group)

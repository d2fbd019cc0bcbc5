"""White-box target attack (the paper's ``optimize_vgg``,
`attack_main2.py:584-671`): Adam on the pixels of every image, each image
on its own trajectory, against

    sum_k w_k * term_k(x)

over the per-image terms of the mix's ``loss_weights`` (the ``attack_main``
preset, `attack_main2.py:649`: 10 latent_target - latent_org
+ img_rec_target + 20 img_org + lpips_img). The codes are the encoder's raw
codes of the pooled image (no mean latent), the reconstruction is the
generator's image of them, and the perceptual term is the sum of the four
VGG16 taps' mean squared differences, all of the pooled image. The bundle
(the original and target codes and the original's taps) is computed once,
without gradients. Terms whose weight is 0 do not touch the pixels and are
not computed.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.attacks import chunks, mse, nchw
from portbench.reference.models import avg_pool

ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)


def _bundle(models, images, target, factor):
    with torch.no_grad():
        r_org, r_t = avg_pool(images, factor), avg_pool(target, factor)
        return dict(img_org=images, target=target, latent_org=models["encoder"](r_org),
                    latent_target=models["encoder"](r_t), feats_org=models["vgg16"](r_org))


def _terms(models, weights, x, ref, factor):
    """Each weighted term of the loss, per image: ``{name: (B,)}``."""
    r_x = avg_pool(x, factor)
    lat = models["encoder"](r_x)
    terms = dict(latent_target=lambda: mse(ref["latent_target"], lat),
                 latent_org=lambda: mse(ref["latent_org"], lat),
                 img_org=lambda: mse(ref["img_org"], x))
    if weights.get("img_rec_target") or weights.get("img_rec_org"):
        rec = models["generator"](lat)
        terms["img_rec_target"] = lambda: mse(ref["target"], rec)
        terms["img_rec_org"] = lambda: mse(ref["img_org"], rec)
    if weights.get("lpips_img"):
        feats = models["vgg16"](r_x)
        terms["lpips_img"] = lambda: sum(mse(a, b) for a, b in zip(feats, ref["feats_org"]))
    for k, w in weights.items():
        if w and k not in terms:
            raise ValueError(f"the reference has no term {k!r}")
    return {k: w * terms[k]() for k, w in weights.items() if w}


def _loss(models, weights, x, ref, factor):
    """Per-image total, (B,)."""
    return sum(_terms(models, weights, x, ref, factor).values())


def _adam(models, weights, x0, ref, factor, lr, steps):
    x = x0.clone()
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    b1, b2, eps = ADAM["b1"], ADAM["b2"], ADAM["eps"]
    for t in range(1, steps + 1):
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_loss(models, weights, xg, ref, factor).sum(), xg)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        x = x - lr * (m / bc1) / ((v / bc2).sqrt() + eps)
    return x.detach()


def answer(models, mix, group):
    return follow(models, mix, group)["adv"]


def follow(models, mix, group):
    """The reference's adversarial batch (NCHW), each image's loss at the
    start, and each weighted term of its loss at its end."""
    p = mix["reference"]
    images, target = nchw(group.images), nchw(group.target)
    out, l_start, t_end = [], [], []
    for s in chunks(images.shape[0], p.get("chunk", images.shape[0])):
        ref = _bundle(models, images[s], target, group.pool_factor)
        adv = _adam(models, p["loss_weights"], images[s], ref, group.pool_factor, p["lr"],
                    p["steps"])
        with torch.no_grad():
            l_start.append(_loss(models, p["loss_weights"], images[s], ref, group.pool_factor))
            t_end.append(_terms(models, p["loss_weights"], adv, ref, group.pool_factor))
        out.append(adv)
    return dict(adv=torch.cat(out), loss_start=torch.cat(l_start),
                terms_end={k: torch.cat([t[k] for t in t_end]) for k in t_end[0]})


def numbers(models, mix, group, adv, followed):
    """The numbers read between the program's result and the reference's,
    each the worst image's, all scored by the reference's loss and taken
    over the reference's fall (its loss at the original image less its
    loss at its own result):

    - ``loss_gap`` (compared): how far the reference's loss at the
      program's result lies from its loss at its own result, either way: 0
      where they meet, 1 where the program did not move or went as far
      again past it. Two-sided, so that a step too long (a larger rate, a
      bias correction dropped) shows as well as one too short;
    - ``term_gap.<term>`` (shown): the same for each weighted term alone,
      which a fault in a term of small weight moves more than the total;
    - ``delta_gap`` (shown): the distance between the two perturbations
      over the reference's."""
    p = mix["reference"]
    images, target, prog = nchw(group.images), nchw(group.target), nchw(adv.float())
    t_prog = []
    with torch.no_grad():
        for s in chunks(images.shape[0], p.get("chunk", images.shape[0])):
            ref = _bundle(models, images[s], target, group.pool_factor)
            t_prog.append(_terms(models, p["loss_weights"], prog[s], ref, group.pool_factor))
    t_prog = {k: torch.cat([t[k] for t in t_prog]) for k in t_prog[0]}
    t_end = followed["terms_end"]
    fall = (followed["loss_start"] - sum(t_end.values())).clamp_min(1e-30)
    out = dict(loss_gap=(sum(t_prog.values()) - sum(t_end.values())).abs() / fall)
    out.update({f"term_gap.{k}": (t_prog[k] - t_end[k]).abs() / fall for k in t_end})
    d_ref = (followed["adv"] - images).flatten(1)
    out["delta_gap"] = ((prog - images).flatten(1) - d_ref).norm(dim=1) / d_ref.norm(
        dim=1).clamp_min(1e-30)
    finite = bool(torch.isfinite(prog).all())
    return {k: float(v.max()) if finite else math.inf for k, v in out.items()}


def flop_parts(models, mix, group):
    p = mix["reference"]
    images, target = nchw(group.images), nchw(group.target)
    ref = {}

    def once():
        ref.update(_bundle(models, images, target, group.pool_factor))

    def step():
        xg = images.detach().requires_grad_(True)
        _loss(models, p["loss_weights"], xg, ref, group.pool_factor).sum().backward()

    return once, step

"""Fusion-aware PGD/FGSM — attacks that differentiate through the whole fusion
pipeline (port of ``tpufusion/attacks/fusion_attack.py``):

    adv inputs (N,S,S,3) -> pool -> e4e -> [mean W+ | hierarchy blend]
    -> StyleGAN2 synthesis -> fused image -> pixel MSE or VGG objective

The PGD loop perturbs all N inputs jointly under one L-inf ball.
"""

from __future__ import annotations

import dataclasses

from tpufusion_torch.attacks.pgd import PGDConfig, make_pgd
from tpufusion_torch.fusion.spatial import spatial_fused
from tpufusion_torch.models.vgg16 import perceptual_distance
from tpufusion_torch.pipeline import FusionPipeline, latents_with


def make_fused_image_fn(pipeline: FusionPipeline, mode: str = "arithmetic"):
    """Differentiable ``fused(inputs) -> (1, S, S, 3)`` through the full
    pipeline. ``mode``: 'arithmetic' (mean W+) or 'spatial' (hierarchy blend
    with the dataset's role map: the inputs are the roles, in order, and
    their number must be the dataset's)."""
    if mode not in ("arithmetic", "spatial"):
        raise ValueError(f"mode must be 'arithmetic' or 'spatial', got {mode!r}")
    gen = pipeline.generator

    def fused(inputs):
        codes = latents_with(pipeline.encoder, pipeline.latent_avg, pipeline.pool_factor,
                             pipeline.is_cars, inputs)
        if mode == "spatial":
            return spatial_fused(pipeline.drawer, codes[None])[0]
        avg = codes.mean(dim=0, keepdim=True)
        return gen(avg, input_is_latent=True).image

    return fused


@dataclasses.dataclass(frozen=True)
class FusionAttackConfig:
    mode: str = "arithmetic"  # or 'spatial'
    objective: str = "pixel"  # 'pixel' (MSE) or 'vgg' (perceptual taps)
    targeted: bool = True     # pull the fused image toward `target`; False: away
    pgd: PGDConfig = PGDConfig(eps=8 / 255 * 2, alpha=0.01 * 2, steps=40)


def make_fusion_loss(pipeline: FusionPipeline, config: FusionAttackConfig):
    """``loss(adv_inputs, target) -> scalar``: the attack's objective, the
    pixel MSE or the VGG16 perceptual distance of the pooled images."""
    if config.objective not in ("pixel", "vgg"):
        raise ValueError(f"objective must be 'pixel' or 'vgg', got {config.objective!r}")
    fused_fn = make_fused_image_fn(pipeline, config.mode)

    if config.objective == "vgg":
        def loss_fn(adv, target):
            return perceptual_distance(pipeline.vgg_feats(fused_fn(adv)),
                                       pipeline.vgg_feats(target))
        return loss_fn

    def loss_fn(adv, target):
        d = fused_fn(adv).float() - target.float()
        return (d * d).mean()

    return loss_fn


def make_fusion_attack(pipeline: FusionPipeline, config: FusionAttackConfig):
    """Build ``attack(inputs, target_fused, generator) -> (adv_inputs, trace)``;
    ``generator`` (a ``torch.Generator``) draws the random start.

    ``inputs``: the (N, S, S, 3) fusion batch; ``target_fused``: a (1, S, S, 3)
    image the fused output should approach (targeted) or flee (untargeted).
    """
    loss_fn = make_fusion_loss(pipeline, config)
    pgd = make_pgd(loss_fn, dataclasses.replace(config.pgd, targeted=config.targeted))

    def attack(inputs, target_fused, generator=None):
        return pgd(inputs, generator, target_fused)

    return attack


def fgsm_on_fusion(pipeline: FusionPipeline, eps: float = 8 / 255 * 2,
                   mode: str = "arithmetic", objective: str = "pixel",
                   targeted: bool = True):
    """1-step FGSM on the fused output (BASELINE config 1)."""
    cfg = FusionAttackConfig(mode=mode, objective=objective, targeted=targeted,
                             pgd=PGDConfig(eps=eps, alpha=eps, steps=1, random_start=False))
    return make_fusion_attack(pipeline, cfg)

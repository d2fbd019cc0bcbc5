"""Partial-fusion evaluation (port of ``tpufusion/eval/partial.py``; the
reference's `interpolation.py:921-1074`).

For j in 0..N-1: substitute only the j-th adversarial latent into the benign
batch and fuse; variant N fuses the all-adversarial batch. Both fusion modes
run the N+1 variants as one batched synthesis: arithmetic fuses the N+1
means in one batch; spatial makes the variant axis the batch of every role's
latent, so the W+ -> s conversions, the hierarchy blend and the synthesis
run once at batch N+1.
"""

from __future__ import annotations

import torch

from tpufusion_torch.eval.metrics import as_tensors
from tpufusion_torch.fusion.arithmetic import arithmetic_fusion
from tpufusion_torch.fusion.drawer import FusionDrawer
from tpufusion_torch.fusion.spatial import spatial_fused, spatial_fusion

MODES = ("spatial", "arithmetic")


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"mode must be 'spatial' or 'arithmetic', got {mode!r}")


def partial_latent_variants(all_latents, all_adv_latents):
    """(N+1, N, n_latent, 512): variant j has row j adversarial; variant N is
    fully adversarial (`interpolation.py:924-933`)."""
    n = all_latents.shape[0]
    adversarial = torch.cat([torch.eye(n, dtype=torch.bool, device=all_latents.device),
                             torch.ones(1, n, dtype=torch.bool, device=all_latents.device)])
    return torch.where(adversarial[:, :, None, None], all_adv_latents[None], all_latents[None])


def partial_adv_fusion(drawer: FusionDrawer, all_latents, all_adv_latents,
                       mode: str = "spatial"):
    """Fused images for every partial substitution, on the drawer's device:
    (N+1, H, W, 3), row j fused with only latent j adversarial, the last row
    all adversarial."""
    _check_mode(mode)
    clean, adv = as_tensors(drawer.device, all_latents, all_adv_latents)
    variants = partial_latent_variants(clean, adv)
    if mode == "arithmetic":
        fused, _ = drawer.w_plus_to_image(variants.mean(dim=1))
    else:
        fused, _ = spatial_fused(drawer, variants)
    return fused


def benign_fusion(drawer: FusionDrawer, all_latents, mode: str = "spatial"):
    """`benign_fusion_spatial/arithmetic` (`interpolation.py:1033-1074`), on
    the drawer's device: (fused, singles, features)."""
    _check_mode(mode)
    (latents,) = as_tensors(drawer.device, all_latents)
    fuse = spatial_fusion if mode == "spatial" else arithmetic_fusion
    return fuse(drawer, latents)

"""Arithmetic (mean-latent) fusion (port of ``tpufusion/fusion/arithmetic.py``):
the mean of N W+ latents -> one synthesis, plus the N reconstructions and
their inner features as one batched pass."""

from __future__ import annotations

from tpufusion_torch.fusion.drawer import FusionDrawer


def arithmetic_fusion(drawer: FusionDrawer, all_latents, feature_idx: int = -1):
    """Args: all_latents (N, n_latent, 512) W+ rows.
    Returns: (fused_image, individual_images, inner_features)."""
    avg = all_latents.mean(dim=0, keepdim=True)
    fused, _ = drawer.w_plus_to_image(avg)
    singles, features = drawer.w_plus_to_image(all_latents)
    return fused, singles, features[feature_idx]

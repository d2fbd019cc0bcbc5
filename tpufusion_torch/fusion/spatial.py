"""Spatial (per-part) fusion (port of ``tpufusion/fusion/spatial.py``; the
reference's ``fusion()``, `attack_main2.py:521-581`).

N role-assigned W+ latents -> one fused image, the N reconstructions and
their inner features. Role maps per dataset (`attack_main2.py:526,547,566`,
the car reconstruction order of `interpolation.py:713-720`):

  ffhq:   [mouth, background, hair, eyes, global]   (N=5)
  car:    [wheels, bg_top, bg_bottom, body]         (N=4)
  church: [bg_top, bg_bottom, body]                 (N=3)
"""

from __future__ import annotations

import torch

from tpufusion_torch.fusion.drawer import FusionDrawer

# role order of the latent rows, how they map onto generate_img keywords, and
# the order the reference reconstructs the individual images in
ROLE_MAPS = {
    "ffhq": dict(
        roles=("mouth", "background", "hair", "eyes", "global"),
        base="global",
        kwargs={"hair": "hair", "eyes": "eyes", "background": "background", "mouth": "mouth"},
        recon=("mouth", "background", "hair", "eyes", "global"),
    ),
    "car": dict(
        roles=("wheels", "bg_top", "bg_bottom", "body"),
        base="body",
        kwargs={"wheels": "wheels", "bg_top": "bg_top", "bg_bottom": "bg_bottom"},
        recon=("body", "wheels", "bg_top", "bg_bottom"),
    ),
    "church": dict(
        roles=("bg_top", "bg_bottom", "body"),
        base="body",
        kwargs={"bg_top": "bg_top", "bg_bottom": "bg_bottom"},
        recon=("body", "bg_top", "bg_bottom"),
    ),
}


def recon_index(dataset: str):
    """Permutation from latent-row order to the reference's reconstruction
    order (identity for ffhq; car and church reconstruct base first)."""
    cfg = ROLE_MAPS[dataset]
    return [cfg["roles"].index(r) for r in cfg["recon"]]


def n_inputs(dataset: str) -> int:
    """The reference's ``dataset_n_dict`` (`attack_main2.py:909`)."""
    return len(ROLE_MAPS[dataset]["roles"])


def spatial_fused(drawer: FusionDrawer, latents: torch.Tensor):
    """(B, N, n_latent, 512) W+ rows in role order -> (B fused images, inner
    features). Each role's batch of B latents is converted to style vectors
    once, blended through the hierarchy and synthesised in one batch."""
    cfg = ROLE_MAPS[drawer.dataset]
    if latents.shape[1] != len(cfg["roles"]):
        raise ValueError(f"{drawer.dataset} spatial fusion needs {len(cfg['roles'])} "
                         f"latents, got {latents.shape[1]}")
    by_role = {r: latents[:, i] for i, r in enumerate(cfg["roles"])}
    kwargs = {kw: by_role[role] for kw, role in cfg["kwargs"].items()}
    return drawer.generate_img(by_role[cfg["base"]], latents_type="w", **kwargs)


def spatial_fusion(drawer: FusionDrawer, all_latents, feature_idx: int = -1):
    """``fusion()`` of the reference.

    Args: all_latents (N, n_latent, 512) W+ rows in role order.
    Returns: (fused_image, individual_images (N, ...), inner_features (N, ...)).

    The reference runs each latent through the blender with identical parts,
    which is the identity blend (g·a + (1-g)·a = a), so the reconstructions
    are one batched synthesis, rows in the reference's reconstruction order.
    """
    fused, _ = spatial_fused(drawer, all_latents[None])
    singles, features = drawer.w_plus_to_image(all_latents[recon_index(drawer.dataset)])
    return fused, singles, features[feature_idx]

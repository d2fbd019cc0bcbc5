"""Fusion drawer — the generator, the hierarchy blender and the mean latent
behind one facade (port of ``tpufusion/fusion/drawer.py``; the reference's
``StyleFusionSimple``): latent conversions (z / w / w+ / s), per-part s-dict
assembly with the reference's swap table, blended synthesis with the inner
features.

Distinct input latents are converted to style vectors once and shared across
the parts they fill. Everything runs eagerly: there is no per-signature
program cache to keep.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpufusion_torch.core.dtypes import Policy, resolve_device
from tpufusion_torch.models.fusion_hierarchy import (
    TREES,
    HierarchyBlender,
    get_all_active_parts,
)
from tpufusion_torch.models.stylegan2 import Generator

# Per-dataset generator config (`style_fusion_simple.py:28-39`).
DATASET_CONFIG = {
    "ffhq": dict(truncation=0.7, size=1024, layers=18),
    "car": dict(truncation=0.5, size=512, layers=16),
    "church": dict(truncation=0.5, size=256, layers=14),
}

# The reference's swap table: keyword -> s_dict keys it overwrites, in call
# order (`style_fusion_simple.py:95-104`; later swaps win, e.g. ``eyes``
# overwrites ``face`` after ``mouth`` set it).
SWAP_TABLE = (
    ("hair", ("bg_hair_clothes", "hair")),
    ("face", ("face", "eyes", "skin_mouth", "mouth", "skin", "shirt")),
    ("background", ("background", "background_top", "background_bottom", "bg")),
    ("all", ("all",)),
    ("mouth", ("skin_mouth", "face")),
    ("eyes", ("eyes", "face")),
    ("wheels", ("wheels",)),
    ("car", ("car", "body", "wheels", "car_body")),
    ("bg_top", ("background_top",)),
    ("bg_bottom", ("background_bottom",)),
)


class FusionDrawer:
    """Holds the generator, the blender and the mean latent."""

    def __init__(self, dataset: str, generator: Generator, mean_latent: torch.Tensor,
                 blender: Optional[HierarchyBlender] = None,
                 truncation: Optional[float] = None):
        self.dataset = dataset
        self.generator = generator
        self.mean_latent = mean_latent
        self.blender = blender
        self.truncation = (truncation if truncation is not None
                           else DATASET_CONFIG[dataset]["truncation"])
        self.parts = get_all_active_parts(TREES[dataset])

    @classmethod
    def create(cls, dataset: str, *, size: Optional[int] = None,
               channel_multiplier: int = 2, policy: Optional[Policy] = None,
               mean_latent_samples: int = 4096, device=None,
               generator: Optional[torch.Generator] = None,
               decoder: Optional[Generator] = None,
               with_blender: bool = True) -> "FusionDrawer":
        """Build a drawer on ``device`` (``cuda`` unless given). The
        StyleGAN2 weights, then the ``mean_latent`` z draws, then the
        blender's weights come from ``generator`` (a ``torch.Generator``).

        ``decoder`` supplies the StyleGAN2 generator instead of drawing one
        (the reference's ``GAN=net.decoder`` path, `attack_main2.py:930-932`):
        the drawer wraps it on its device. ``with_blender=False`` leaves
        ``blender`` unset for the caller to draw later (``draw_blender``), so
        that other weights can be drawn from ``generator`` before it."""
        if decoder is None:
            device = resolve_device(device)
            decoder = Generator(size or DATASET_CONFIG[dataset]["size"],
                                channel_multiplier=channel_multiplier, policy=policy,
                                device=device, generator=generator)
        decoder.requires_grad_(False)
        with torch.no_grad():
            mean_latent = decoder.mean_latent(mean_latent_samples, generator=generator)
        drawer = cls(dataset, decoder, mean_latent)
        if with_blender:
            drawer.draw_blender(generator)
        return drawer

    def draw_blender(self, generator: Optional[torch.Generator] = None) -> HierarchyBlender:
        """Draw fresh, frozen fusion nets from ``generator`` on the
        generator's device."""
        self.blender = HierarchyBlender(self.dataset, self.generator.style_input_dims(),
                                        device=self.device, generator=generator)
        self.blender.requires_grad_(False)
        return self.blender

    @property
    def device(self) -> torch.device:
        return self.generator.device

    # ---- latent conversions (`style_fusion_simple.py:110-144`) ------------
    def seed_to_z(self, seed: tuple) -> torch.Tensor:
        """(seed, index) -> one (1, 512) z: the index-th of index+1 normal
        draws of a ``torch.Generator`` seeded with ``seed`` (the reference's
        scheme; the JAX package draws them with its own PRNG, so the values
        differ)."""
        s, idx = int(seed[0]), int(seed[1])
        z = torch.randn((idx + 1, 1, 512), generator=torch.Generator().manual_seed(s))
        return z[idx].to(self.device)

    def _to_s(self, latents_type: str):
        """The one latent-type dispatch: ``latent -> style vectors``. z takes
        the dataset truncation; w and w+ convert at truncation 1 (a (1, 512)
        w is broadcast to every layer by the generator); s passes through.
        An unknown type raises here, before any work."""
        if latents_type == "z":
            return self.z_to_s
        if latents_type in ("w", "w+"):
            return self.w_plus_to_s
        if latents_type == "s":
            return lambda latent: latent
        raise ValueError(f"latents_type must be z/w/w+/s, got {latents_type!r}")

    def z_to_s(self, z):
        return self.generator(z, truncation=self.truncation,
                              truncation_latent=self.mean_latent, return_style_vector=True)

    def w_plus_to_s(self, w_plus, truncation: float = 1.0):
        """W+ -> style vectors; ``truncation`` < 1 pulls toward the mean latent."""
        return self.generator(w_plus, input_is_latent=True, truncation=truncation,
                              truncation_latent=self.mean_latent,
                              return_style_vector=True)

    def general_latent_to_s(self, latent, latent_type: str):
        """`style_fusion_simple.py:131-144`: z / w / w+ / s -> s."""
        return self._to_s(latent_type)(latent)

    def z_to_w_plus(self, z):
        """z -> broadcast, truncated W+ (`style_fusion_simple.py:120-124`)."""
        return self.generator._to_w_plus([z], False, self.truncation, self.mean_latent,
                                         None)

    # ---- synthesis -----------------------------------------------------------
    def s_to_image(self, s):
        """Style vectors -> (image, inner features)."""
        out = self.generator(style_vector=s)
        return out.image, out.features

    def s_dict_to_image(self, s_dict):
        """Blend the per-part s-dict through the hierarchy, then synthesise."""
        return self.s_to_image(self.blender(s_dict))

    def w_plus_to_image(self, w_plus):
        return self.s_to_image(self.w_plus_to_s(w_plus))

    def z_to_image(self, z):
        return self.s_to_image(self.z_to_s(z))

    def w_plus_dict_to_image(self, w_plus_dict, truncation: float = 1.0):
        """Per-part W+ dict -> fused image; ``truncation`` applies per part."""
        s_dict = {k: self.w_plus_to_s(v, truncation) for k, v in w_plus_dict.items()}
        return self.s_dict_to_image(self._fill_s_dict(s_dict))

    def z_dict_to_image(self, z_dict):
        """Per-part z dict -> fused image."""
        s_dict = {k: self.z_to_s(v) for k, v in z_dict.items()}
        return self.s_dict_to_image(self._fill_s_dict(s_dict))

    def _fill_s_dict(self, s_dict):
        """Complete a partial per-part dict: unspecified parts take the
        'all' entry, which must be given."""
        if "all" not in s_dict:
            raise ValueError("part dict needs an 'all' entry as the base")
        base = s_dict["all"]
        return {p: s_dict.get(p, base) for p in self.parts}

    # ---- generate_img (`style_fusion_simple.py:82-108`) ----------------------
    def generate_img(self, base_latent, latents_type: str = "z", **part_latents):
        """Fused synthesis: every part starts from ``base_latent``, then the
        swap table is applied, in its order, for each keyword given
        (hair / face / background / all / mouth / eyes / wheels / car /
        bg_top / bg_bottom). Returns (image, inner features)."""
        unknown = set(part_latents) - {k for k, _ in SWAP_TABLE}
        if unknown:
            raise TypeError(f"unknown part keywords: {sorted(unknown)}")
        to_s = self._to_s(latents_type)
        s_base = to_s(base_latent)
        s_dict = {p: s_base for p in self.parts}
        for kw, keys in SWAP_TABLE:
            if part_latents.get(kw) is not None:
                s_kw = to_s(part_latents[kw])
                for k in keys:
                    if k in s_dict:
                        s_dict[k] = s_kw
        return self.s_dict_to_image(s_dict)

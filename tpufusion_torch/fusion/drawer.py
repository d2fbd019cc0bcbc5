"""Fusion drawer — the generator, its weights and the mean latent (port of the
part of ``tpufusion/fusion/drawer.py`` that arithmetic fusion needs).

The hierarchy blender, ``SWAP_TABLE`` and the z / s conversions wait for the
spatial-fusion slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpufusion_torch.core.dtypes import Policy, resolve_device
from tpufusion_torch.models.stylegan2 import Generator

# Per-dataset generator resolution (`style_fusion_simple.py:28-39`).
DATASET_SIZE = {"ffhq": 1024, "car": 512, "church": 256}


class FusionDrawer:
    """Holds the generator and the mean latent."""

    def __init__(self, dataset: str, generator: Generator, mean_latent: torch.Tensor):
        self.dataset = dataset
        self.generator = generator
        self.mean_latent = mean_latent

    @classmethod
    def create(cls, dataset: str, *, size: Optional[int] = None,
               channel_multiplier: int = 2, policy: Optional[Policy] = None,
               mean_latent_samples: int = 4096, device=None,
               generator: Optional[torch.Generator] = None) -> "FusionDrawer":
        """Build a drawer on ``device`` (``cuda`` unless given) with a fresh
        generator whose weights, and the ``mean_latent`` z draws, come from
        ``generator``."""
        device = resolve_device(device)
        size = size or DATASET_SIZE[dataset]
        gen = Generator(size, channel_multiplier=channel_multiplier, policy=policy,
                        device=device, generator=generator)
        gen.requires_grad_(False)
        with torch.no_grad():
            mean_latent = gen.mean_latent(mean_latent_samples, generator=generator)
        return cls(dataset, gen, mean_latent)

    def w_plus_to_s(self, w_plus, truncation: float = 1.0):
        """W+ -> style vectors; ``truncation`` < 1 pulls toward the mean latent."""
        return self.generator(w_plus, input_is_latent=True, truncation=truncation,
                              truncation_latent=self.mean_latent,
                              return_style_vector=True)

    def s_to_image(self, s):
        """Style vectors -> (image, inner features)."""
        out = self.generator(style_vector=s)
        return out.image, out.features

    def w_plus_to_image(self, w_plus):
        return self.s_to_image(self.w_plus_to_s(w_plus))

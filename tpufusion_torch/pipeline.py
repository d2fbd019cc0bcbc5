"""FusionPipeline — the model bundle the attacks work against (port of
``tpufusion/pipeline.py``): an e4e encoder + StyleGAN2 decoder pair, the
drawer wrapping the same decoder and the fusion hierarchy, the VGG16
perceptual taps and ``latent_avg``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.core.imaging import avg_pool
from tpufusion_torch.fusion.drawer import FusionDrawer
from tpufusion_torch.models.e4e import Encoder4Editing
from tpufusion_torch.models.vgg16 import VGG16


def latents_with(encoder, latent_avg, pool_factor: int, is_cars: bool, images):
    """Encoder + latent-average offset + cars 18->16 trim
    (`attack_main2.py:137-146`): the one latent definition, shared with the
    attack's fused-image function."""
    codes = encoder(avg_pool(images, pool_factor))
    codes = codes + latent_avg[None].to(codes.dtype)
    if is_cars and codes.shape[1] == 18:
        codes = codes[:, :16]
    return codes


@dataclasses.dataclass
class FusionPipeline:
    dataset: str
    drawer: FusionDrawer
    encoder: Encoder4Editing
    vgg: VGG16
    latent_avg: torch.Tensor  # (n_latent, 512) float32
    policy: Policy
    encoder_input_size: int = 256

    @classmethod
    def create(cls, dataset: str, *, size: Optional[int] = None,
               channel_multiplier: int = 2, encoder_base_channels: int = 64,
               encoder_units=(3, 4, 14, 3), encoder_input_size: int = 256,
               mean_latent_samples: int = 4096, policy: Optional[Policy] = None,
               device=None, seed: int = 0) -> "FusionPipeline":
        """Build the bundle with weights drawn from ``seed`` on ``device``
        (``cuda`` unless given). Every weight is frozen: the attacks
        differentiate with respect to the pixels only. The draws go
        generator, mean latent, encoder, VGG, then the fusion nets, so a seed
        gives the same generator, encoder and VGG with or without the later
        ones."""
        device = resolve_device(device)
        policy = policy or default_policy(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        drawer = FusionDrawer.create(
            dataset, size=size, channel_multiplier=channel_multiplier, policy=policy,
            mean_latent_samples=mean_latent_samples, device=device, generator=gen,
            with_blender=False)
        n_styles = drawer.generator.n_latent
        encoder = Encoder4Editing(
            n_styles, base_channels=encoder_base_channels, unit_counts=encoder_units,
            input_size=encoder_input_size, policy=policy, device=device, generator=gen)
        encoder.requires_grad_(False)
        vgg = VGG16(policy=policy, device=device, generator=gen)
        vgg.requires_grad_(False)
        drawer.draw_blender(gen)
        latent_avg = drawer.mean_latent.repeat(n_styles, 1)
        return cls(dataset=dataset, drawer=drawer, encoder=encoder, vgg=vgg,
                   latent_avg=latent_avg, policy=policy,
                   encoder_input_size=encoder_input_size)

    @property
    def generator(self):
        return self.drawer.generator

    @property
    def image_size(self) -> int:
        return self.generator.size

    @property
    def pool_factor(self) -> int:
        return max(self.image_size // self.encoder_input_size, 1)

    @property
    def is_cars(self) -> bool:
        return "car" in self.dataset

    def pool_to_encoder(self, images):
        return avg_pool(images, self.pool_factor)

    def encode(self, images):
        """Full-resolution images -> raw codes (pools first)."""
        return self.encoder(self.pool_to_encoder(images))

    def get_latents(self, images):
        """Encoder + ``latent_avg`` offset + cars trim."""
        return latents_with(self.encoder, self.latent_avg, self.pool_factor,
                            self.is_cars, images)

    def decode(self, w_plus):
        """Raw W+ codes -> image (``decoder([codes], input_is_latent=True)``)."""
        return self.generator(w_plus, input_is_latent=True).image

    def vgg_feats(self, images):
        """Pools to the encoder size, then the four perceptual taps."""
        return self.vgg(self.pool_to_encoder(images))

"""FusionPipeline — the model bundle the attacks work against (port of
``tpufusion/pipeline.py``): an e4e encoder + StyleGAN2 decoder pair, the
drawer wrapping the same decoder and the fusion hierarchy, the VGG16
perceptual taps and ``latent_avg``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.core.imaging import avg_pool
from tpufusion_torch.fusion.drawer import FusionDrawer
from tpufusion_torch.io.convert import (
    encoder_state_from_jax,
    encoder_state_to_jax,
    generator_state_from_jax,
    generator_state_to_jax,
    state_dict_to_torch,
    vgg_state_from_jax,
    vgg_state_to_jax,
)
from tpufusion_torch.io.params_io import load_pytree, save_pytree
from tpufusion_torch.models.e4e import Encoder4Editing
from tpufusion_torch.models.fusion_hierarchy import HierarchyBlender
from tpufusion_torch.models.stylegan2 import Generator
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

    # ---- persistence ---------------------------------------------------
    def save(self, directory: str) -> str:
        """Write every weight in the JAX package's layout (``generator.npz``,
        ``encoder.npz``, ``vgg.npz``, ``fusion_nets.npz``, ``latents.npz``
        and ``pipeline.json``), so either package's ``load`` reads it."""
        os.makedirs(directory, exist_ok=True)
        save_pytree(generator_state_to_jax(self.generator.state_dict(), self.image_size),
                    os.path.join(directory, "generator.npz"))
        save_pytree(encoder_state_to_jax(self.encoder.state_dict(), self.encoder.unit_counts,
                                         self.encoder.coarse_ind, self.encoder.middle_ind),
                    os.path.join(directory, "encoder.npz"))
        save_pytree(vgg_state_to_jax(self.vgg.state_dict()), os.path.join(directory, "vgg.npz"))
        save_pytree(self.drawer.blender.jax_params(),
                    os.path.join(directory, "fusion_nets.npz"))
        save_pytree(dict(mean_latent=self.drawer.mean_latent, latent_avg=self.latent_avg),
                    os.path.join(directory, "latents.npz"))
        meta = dict(
            dataset=self.dataset,
            size=self.image_size,
            channel_multiplier=self.generator.channel_multiplier,
            encoder_input_size=self.encoder_input_size,
            encoder_base_channels=self.encoder.base_channels,
            encoder_units=list(self.encoder.unit_counts),
            n_styles=self.encoder.n_styles,
        )
        with open(os.path.join(directory, "pipeline.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return directory

    @classmethod
    def load(cls, directory: str, *, policy: Optional[Policy] = None,
             device=None) -> "FusionPipeline":
        """Rebuild a pipeline from a directory ``save`` wrote (by either
        package) on ``device`` (``cuda`` unless given), every weight
        frozen. The modules are built with throwaway draws, then loaded."""
        device = resolve_device(device)
        policy = policy or default_policy(device)
        with open(os.path.join(directory, "pipeline.json")) as f:
            meta = json.load(f)

        def tree(name):
            return load_pytree(os.path.join(directory, name))

        def filled(module, state):
            module.load_state_dict(state_dict_to_torch(state, device))
            return module.requires_grad_(False)

        gen = torch.Generator(device=device).manual_seed(0)
        size, units = meta["size"], tuple(meta["encoder_units"])
        generator = filled(Generator(size, channel_multiplier=meta["channel_multiplier"],
                                   policy=policy, device=device, generator=gen),
                         generator_state_from_jax(tree("generator.npz"), size))
        encoder = filled(Encoder4Editing(
            meta["n_styles"], base_channels=meta["encoder_base_channels"], unit_counts=units,
            input_size=meta["encoder_input_size"], policy=policy, device=device,
            generator=gen), encoder_state_from_jax(tree("encoder.npz"), units))
        vgg = filled(VGG16(policy=policy, device=device, generator=gen),
                   vgg_state_from_jax(tree("vgg.npz")))
        blender = HierarchyBlender(meta["dataset"], generator.style_input_dims(),
                                   device=device, generator=gen)
        blender.load_jax_params(tree("fusion_nets.npz"))
        blender.requires_grad_(False)
        lat = tree("latents.npz")
        drawer = FusionDrawer(meta["dataset"], generator,
                              torch.from_numpy(lat["mean_latent"]).to(device), blender)
        return cls(dataset=meta["dataset"], drawer=drawer, encoder=encoder, vgg=vgg,
                   latent_avg=torch.from_numpy(lat["latent_avg"]).to(device), policy=policy,
                   encoder_input_size=meta["encoder_input_size"])

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


def create_test_pipeline(dataset: str = "ffhq", size: int = 32, *, device=None,
                         seed: int = 0) -> FusionPipeline:
    """Tiny fp32 pipeline for tests: a ``size``^2 generator (channel
    multiplier 1), a four-unit encoder of base width 16, 32 mean-latent
    samples; on ``device`` (``cuda`` unless given)."""
    return FusionPipeline.create(
        dataset, size=size, channel_multiplier=1, encoder_base_channels=16,
        encoder_units=(1, 1, 1, 1), encoder_input_size=size, mean_latent_samples=32,
        policy=Policy(), device=device, seed=seed)

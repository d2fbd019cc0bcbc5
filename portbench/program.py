"""The system under test: ``tpufusion_torch`` driven through its runner.

This is the one module of the benchmark that imports the program. It builds
the program's ``FusionPipeline`` from the benchmark's state dicts (the
published checkpoints' layout, loaded with ``load_state_dict`` as a
checkpoint is) and runs one group through
``tpufusion_torch.runner.dispatch_attack``, the call that ``attack_run``
makes for each group, with no run directory and no mesh.
"""

from __future__ import annotations

import dataclasses

import torch

def load_kernels() -> float:
    """Build what is stale and load every hand-written kernel library
    (``build/tpufusion_torch/`` inside the checkout); returns the seconds
    spent building (0.0 when every library was there)."""
    from tpufusion_torch.ops import _lib

    stale = [n for n in _lib.SOURCES if _lib._stale(n)]
    built = _lib.build(stale) if stale else 0.0
    for name in _lib.SOURCES:
        _lib.load(name)
    return built


def build_pipeline(config: dict, state: dict, mean_latent: torch.Tensor, device):
    """The program's pipeline holding ``state``'s tensors (on ``device``)
    as its weights, every weight frozen, computing in the config's
    ``compute_dtype``; its drawer holds StyleFusion's fusion nets where the
    config has a ``fusion_nets`` block, and none otherwise."""
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.fusion.drawer import FusionDrawer
    from tpufusion_torch.models.e4e import Encoder4Editing
    from tpufusion_torch.models.fusion_hierarchy import HierarchyBlender
    from tpufusion_torch.models.stylegan2 import Generator
    from tpufusion_torch.models.vgg16 import VGG16
    from tpufusion_torch.pipeline import FusionPipeline

    policy = Policy(compute_dtype=getattr(torch, config["compute_dtype"]))
    g, e = config["generator"], config["encoder"]
    # built on ``meta`` (shapes only, nothing drawn), then given the state's
    # tensors by ``load_state_dict(assign=True)``: no weight is made twice
    gen = Generator(g["size"], g["style_dim"], g["n_mlp"], g["channel_multiplier"],
                    policy=policy, device="meta")
    enc = Encoder4Editing(e["n_styles"], g["style_dim"], e["base_channels"],
                          tuple(e["unit_counts"]), e["input_size"], e["coarse_ind"],
                          e["middle_ind"], policy=policy, device="meta")
    vgg = VGG16(policy=policy, device="meta")
    for module, name in ((gen, "generator"), (enc, "encoder"), (vgg, "vgg16")):
        module.load_state_dict(state[name], assign=True)
        module.requires_grad_(False)
    blender = None
    if "fusion_nets" in config:
        # built on the device, as the port builds it, its own draws (from a
        # generator of its own) then overwritten by the state's
        blender = HierarchyBlender(config["dataset"], gen.style_input_dims(),
                                   hidden=int(config["fusion_nets"]["hidden"]), device=device,
                                   generator=torch.Generator(device=device).manual_seed(0))
        blender.load_state_dict(state["fusion_nets"])
        blender.requires_grad_(False)
    drawer = FusionDrawer(config["dataset"], gen, mean_latent.to(device), blender)
    return FusionPipeline(dataset=config["dataset"], drawer=drawer, encoder=enc, vgg=vgg,
                          latent_avg=drawer.mean_latent.repeat(e["n_styles"], 1),
                          policy=policy, encoder_input_size=e["input_size"])


def run_config(config: dict, attack: str, settings: dict):
    """The runner's ``AttackRunConfig`` for one attack with ``settings``
    (its fields, as the traffic mix gives them)."""
    from tpufusion_torch.configs import AttackRunConfig

    fields = {f.name for f in dataclasses.fields(AttackRunConfig)}
    unknown = set(settings) - fields
    if unknown:
        raise ValueError(f"unknown AttackRunConfig fields {sorted(unknown)}")
    return AttackRunConfig(dataset_name=config["dataset"], attacks=(attack,), **settings)


def dispatch(pipeline, attack: str, images, target, cfg, generator) -> torch.Tensor:
    """One group: ``dispatch_attack`` with no run directory and no mesh;
    the adversarial batch it returns."""
    from tpufusion_torch.runner import dispatch_attack

    (adv,) = dispatch_attack(pipeline, attack, images, target, cfg, generator)
    return adv

from tpufusion_torch.io.convert import (
    blender_state_from_jax,
    blender_state_to_jax,
    discriminator_state_from_jax,
    encoder_state_from_jax,
    encoder_state_to_jax,
    generator_state_from_jax,
    generator_state_to_jax,
    lpips_state_from_jax,
    resnet_state_from_jax,
    state_dict_to_torch,
    vgg_state_from_jax,
    vgg_state_to_jax,
    vit_state_from_jax,
)
from tpufusion_torch.io.params_io import load_pytree, save_pytree

__all__ = ["blender_state_from_jax", "blender_state_to_jax", "discriminator_state_from_jax",
           "encoder_state_from_jax", "encoder_state_to_jax", "generator_state_from_jax",
           "generator_state_to_jax", "load_pytree", "lpips_state_from_jax",
           "resnet_state_from_jax", "save_pytree", "state_dict_to_torch", "vgg_state_from_jax",
           "vgg_state_to_jax", "vit_state_from_jax"]

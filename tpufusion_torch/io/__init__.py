from tpufusion_torch.io.convert import (
    blender_state_from_jax,
    encoder_state_from_jax,
    generator_state_from_jax,
    lpips_state_from_jax,
    state_dict_to_torch,
    vgg_state_from_jax,
)

__all__ = ["blender_state_from_jax", "encoder_state_from_jax", "generator_state_from_jax",
           "lpips_state_from_jax", "state_dict_to_torch", "vgg_state_from_jax"]

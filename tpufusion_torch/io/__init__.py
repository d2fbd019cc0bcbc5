from tpufusion_torch.io.convert import (
    encoder_state_from_jax,
    generator_state_from_jax,
    state_dict_to_torch,
    vgg_state_from_jax,
)

__all__ = ["encoder_state_from_jax", "generator_state_from_jax", "state_dict_to_torch",
           "vgg_state_from_jax"]

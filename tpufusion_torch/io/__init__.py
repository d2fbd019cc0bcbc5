from tpufusion_torch.io.artifacts import (
    ArtifactStore,
    new_adv_dir,
    new_run_folder,
    write_parameters,
)
from tpufusion_torch.io.attack_state import (
    load_attack_state,
    run_whitebox_resumable,
    run_whitebox_sharded_resumable,
    save_attack_state,
)
from tpufusion_torch.io.convert import (
    blender_state_from_jax,
    blender_state_to_jax,
    discriminator_state_from_jax,
    encoder_state_from_jax,
    encoder_state_to_jax,
    generator_state_from_jax,
    generator_state_to_jax,
    landmark_state_from_jax,
    landmark_state_to_jax,
    lpips_state_from_jax,
    resnet_state_from_jax,
    state_dict_to_torch,
    vgg_state_from_jax,
    vgg_state_to_jax,
    vit_state_from_jax,
)
from tpufusion_torch.io.export import (
    export_decode,
    export_program,
    export_spatial_fusion,
    load_program,
)
from tpufusion_torch.io.images import load_image, save_image, save_montage
from tpufusion_torch.io.params_io import load_pytree, save_pytree

__all__ = ["ArtifactStore", "blender_state_from_jax", "blender_state_to_jax",
           "discriminator_state_from_jax", "encoder_state_from_jax", "encoder_state_to_jax",
           "export_decode", "export_program", "export_spatial_fusion",
           "generator_state_from_jax", "generator_state_to_jax", "landmark_state_from_jax",
           "landmark_state_to_jax", "load_attack_state", "load_image", "load_program",
           "load_pytree",
           "lpips_state_from_jax", "new_adv_dir", "new_run_folder", "resnet_state_from_jax",
           "run_whitebox_resumable", "run_whitebox_sharded_resumable", "save_attack_state",
           "save_image", "save_montage",
           "save_pytree", "state_dict_to_torch", "vgg_state_from_jax", "vgg_state_to_jax",
           "vit_state_from_jax", "write_parameters"]

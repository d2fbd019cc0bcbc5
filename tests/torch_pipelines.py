"""Shared pieces of the port's parity tests (``tests/test_torch_*.py``).

- ``one_torch_thread``: a module-scoped autouse fixture; a test module that
  imports it runs its torch work on one intra-op thread, since the test
  workers share the machine's cores (restored after the module);
- ``port_of``: the port's 32^2 pipeline on the weights of the JAX package's
  ``create_test_pipeline``.
"""

import jax
import numpy as np
import pytest
import torch

from tpufusion_torch.io.convert import (
    blender_state_from_jax,
    encoder_state_from_jax,
    generator_state_from_jax,
    state_dict_to_torch,
    vgg_state_from_jax,
)
from tpufusion_torch.pipeline import FusionPipeline


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_of(jp):
    """The port's 32^2 pipeline on the JAX test pipeline ``jp``'s weights."""
    tp = FusionPipeline.create(
        "ffhq", size=32, channel_multiplier=1, encoder_base_channels=16,
        encoder_units=(1, 1, 1, 1), encoder_input_size=32, mean_latent_samples=8,
        device="cpu", seed=0)
    tp.generator.load_state_dict(state_dict_to_torch(generator_state_from_jax(
        np_tree(jp.drawer.gen_vars), 32, 1)))
    tp.encoder.load_state_dict(state_dict_to_torch(encoder_state_from_jax(
        np_tree(jp.enc_vars), (1, 1, 1, 1))))
    tp.vgg.load_state_dict(state_dict_to_torch(vgg_state_from_jax(np_tree(jp.vgg_vars))))
    tp.drawer.blender.load_state_dict(state_dict_to_torch(blender_state_from_jax(
        np_tree(jp.drawer.blend_params))))
    tp.latent_avg = torch.from_numpy(np.array(jp.latent_avg))
    tp.drawer.mean_latent = torch.from_numpy(np.array(jp.drawer.mean_latent))
    return tp

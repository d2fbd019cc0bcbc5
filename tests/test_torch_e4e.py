"""Parity of the port's e4e encoder and checkpoint converters.

- The tiny encoder (base_channels=16, as ``tpufusion/pipeline.py``'s test
  pipeline builds it) matches JAX on the same weights, carried across by
  ``tpufusion_torch.io.convert``; BatchNorm statistics and PReLU slopes are
  randomised so the frozen-BN path is exercised.
- Converter round trips: ``tests/torch_ref.py`` state dicts -> JAX
  (``tpufusion.io.checkpoint``) -> port (``tpufusion_torch.io.convert``)
  reproduce the original state dicts exactly, and load strictly into the
  port's modules.
CPU, float32; tolerance atol = rtol = 2e-4 (tests/test_goldens.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tests.torch_ref import Encoder4EditingT, GeneratorT
from tpufusion.core.dtypes import Policy as JPolicy
from tpufusion.io.checkpoint import convert_e4e_checkpoint, convert_stylegan2_checkpoint
from tpufusion.models.e4e import Encoder4Editing as JEncoder
from tpufusion.models.e4e import create_encoder
from tpufusion.models.stylegan2 import Generator as JGenerator
from tpufusion_torch.io.convert import (
    encoder_state_from_jax,
    generator_state_from_jax,
    state_dict_to_torch,
)
from tpufusion_torch.models.e4e import Encoder4Editing
from tpufusion_torch.models.stylegan2 import Generator

TOL = dict(atol=2e-4, rtol=2e-4)


def _perturb(tree, rng):
    """Random BN statistics / affine and PReLU slopes (JAX init leaves them
    at identity / 0.25)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("mean", "bias", "alpha"):
            out[k] = np.asarray(v) + rng.uniform(-0.1, 0.1, np.shape(v)).astype(np.float32)
        elif k in ("var", "scale"):
            out[k] = np.asarray(v) * rng.uniform(0.7, 1.3, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("units", [(1, 1, 1, 1), (2, 1, 2, 1)])
def test_tiny_encoder_matches_jax(units):
    enc, variables = create_encoder(jax.random.key(1), 8, image_size=32, base_channels=16,
                                    unit_counts=units, policy=JPolicy())
    v_np = {"params": _perturb(jax.tree.map(np.asarray, variables)["params"],
                               np.random.default_rng(0))}
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y_j = jax.jit(enc.apply)(jax.tree.map(jnp.asarray, v_np), jnp.asarray(x))

    port = Encoder4Editing(8, base_channels=16, unit_counts=units, input_size=32,
                           device="cpu")
    port.load_state_dict(state_dict_to_torch(encoder_state_from_jax(v_np, units)))
    with torch.no_grad():
        y_t = port(torch.from_numpy(x))
    assert tuple(y_t.shape) == (2, 8, 512) and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


def test_encoder_matches_torch_reference_nchw():
    """Against the independent NCHW e4e of tests/torch_ref.py with its own
    state dict (style_dim 128 = the last stage's width, so no c3_proj)."""
    torch.manual_seed(0)
    ref = Encoder4EditingT(n_styles=8, style_dim=128, base_channels=16,
                           unit_counts=(2, 1, 1, 1)).build_heads(32).eval()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.7, 1.3)
    port = Encoder4Editing(8, style_dim=128, base_channels=16, unit_counts=(2, 1, 1, 1),
                           input_size=32, device="cpu")
    port.load_state_dict(ref.state_dict())  # strict: same names and shapes
    x = torch.rand(2, 3, 32, 32) * 2 - 1
    with torch.no_grad():
        y_ref = ref(x)
        y_port = port(x.permute(0, 2, 3, 1).contiguous())
    np.testing.assert_allclose(y_port.numpy(), y_ref.numpy(), **TOL)


def _assert_same_state(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_generator_converter_round_trip():
    torch.manual_seed(1)
    ref = GeneratorT(32, channel_multiplier=1)
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    jvars = convert_stylegan2_checkpoint(sd, JGenerator(size=32, channel_multiplier=1))
    back = generator_state_from_jax(jvars, 32, 1)
    _assert_same_state(back, sd)
    port = Generator(32, channel_multiplier=1, device="cpu")
    assert set(port.state_dict()) == set(sd)  # rosinality g_ema layout
    port.load_state_dict(state_dict_to_torch(back))


def test_encoder_converter_round_trip():
    torch.manual_seed(2)
    units = (2, 1, 2, 1)
    ref = Encoder4EditingT(n_styles=8, base_channels=16, unit_counts=units).build_heads(32)
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    jvars, _ = convert_e4e_checkpoint(
        {f"encoder.{k}": v for k, v in sd.items()},
        JEncoder(n_styles=8, base_channels=16, unit_counts=units))
    back = encoder_state_from_jax(jax.tree.map(np.asarray, jvars), units)
    _assert_same_state(back, sd)
    port = Encoder4Editing(8, base_channels=16, unit_counts=units, input_size=32,
                           device="cpu")
    missing, unexpected = port.load_state_dict(state_dict_to_torch(back), strict=False)
    # the tiny encoder's last stage (128) is not 512 wide: only c3_proj is extra
    assert sorted(missing) == ["c3_proj.bias", "c3_proj.weight"] and not unexpected

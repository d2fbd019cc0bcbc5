"""Parity of the port's VGG16 perceptual taps with the JAX package.

- the four taps match ``tpufusion.models.vgg16.VGG16`` on the same weights
  (carried across by ``tpufusion_torch.io.convert.vgg_state_from_jax``, with
  random biases) at 32^2 and at 36^2, where pool3's ceil mode keeps a ragged
  last row and column (9^2 -> 5^2);
- the reference layout (``tests/torch_ref.py::VGGBaseT``, the layout of the
  published ``imagenet_vgg16.pth``) loads strictly and gives the same taps;
- ``perceptual_distance`` matches JAX's.
CPU, float32; tolerance atol = rtol = 2e-4 (tests/test_goldens.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tests.torch_ref import VGGBaseT, nchw_to_nhwc
from tpufusion.core.dtypes import Policy as JPolicy
from tpufusion.models.vgg16 import create_vgg16
from tpufusion.models.vgg16 import perceptual_distance as j_perceptual_distance
from tpufusion_torch.io.convert import state_dict_to_torch, vgg_state_from_jax
from tpufusion_torch.models.vgg16 import VGG16, perceptual_distance

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def vggs():
    jv, variables = create_vgg16(jax.random.key(2), policy=JPolicy(), image_size=32)
    rng = np.random.default_rng(3)
    v_np = {"params": {name: dict(kernel=np.asarray(layer["kernel"]),
                                  bias=rng.uniform(-0.1, 0.1, np.shape(layer["bias"]))
                                  .astype(np.float32))
                       for name, layer in variables["params"].items()}}
    tv = VGG16(device="cpu")
    tv.load_state_dict(state_dict_to_torch(vgg_state_from_jax(v_np)))
    return jax.jit(jv.apply), jax.tree.map(jnp.asarray, v_np), tv


@pytest.mark.parametrize("size,deep", [(32, 4), (36, 5)])
def test_taps_match_jax(vggs, size, deep):
    j_apply, v, tv = vggs
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = j_apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tv(torch.from_numpy(x))
    half = size // 2
    shapes = [(2, size, size, 64), (2, size, size, 64), (2, half // 2, half // 2, 128),
              (2, deep, deep, 512)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_reference_layout_loads_and_matches():
    torch.manual_seed(0)
    ref = VGGBaseT().eval()
    tv = VGG16(device="cpu")
    tv.load_state_dict(ref.state_dict(), strict=True)
    x = np.random.default_rng(4).uniform(-1, 1, (1, 36, 36, 3)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = tv(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), nchw_to_nhwc(w), **TOL)


def test_perceptual_distance_matches_jax(vggs):
    j_apply, v, tv = vggs
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = j_perceptual_distance(j_apply(v, jnp.asarray(a)), j_apply(v, jnp.asarray(b)))
    with torch.no_grad():
        got = perceptual_distance(tv(torch.from_numpy(a)), tv(torch.from_numpy(b)))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

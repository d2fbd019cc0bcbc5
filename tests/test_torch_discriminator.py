"""Parity of the port's discriminator with the JAX package, CPU, float32.

- the 32^2 discriminator (channel multiplier 1) carried across with
  ``discriminator_state_from_jax``: ``realism_scores`` at batches 4, 3, 6
  and 5 (the minibatch-stddev group is the largest divisor of the batch not
  above 4: 4, 3, 3 and 1), to 2e-4 of max(1, max |score|);
- synthetic ada ``D`` tensors (built as ``tests/test_ada_pkl.py`` builds
  them): JAX's ``convert_ada_discriminator`` and the port's
  ``load_ada_discriminator`` give the same scores, also through a pickle
  read by each package's permissive loader; the port's ``collect_tensors``
  finds the paths JAX's finds;
- ``downsample_2x`` against JAX's at even and odd sizes, to 1e-6.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import np_tree, one_torch_thread  # noqa: F401
from tpufusion.core.dtypes import Policy as JPolicy
from tpufusion.io import ada_pkl as j_ada
from tpufusion.io.checkpoint import convert_ada_discriminator
from tpufusion.models.discriminator import Discriminator as JDiscriminator
from tpufusion.models.discriminator import realism_scores as j_realism_scores
from tpufusion.ops.upfirdn2d import downsample_2x as j_downsample_2x
from tpufusion_torch.io import ada_pkl as t_ada
from tpufusion_torch.io.convert import discriminator_state_from_jax, state_dict_to_torch
from tpufusion_torch.models.discriminator import (
    create_discriminator,
    load_ada_discriminator,
    realism_scores,
)
from tpufusion_torch.ops.upfirdn2d import downsample_2x

SIZE = 32


def _close(got, want, tol=2e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def discriminators():
    jd = JDiscriminator(size=SIZE, channel_multiplier=1, policy=JPolicy())
    jv = np_tree(jax.jit(jd.init)(jax.random.key(2), jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.default_rng(12)
    # non-zero biases, so that a bias read from the wrong layer shows
    jv = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if p[-1].key == "bias" else a, jv)
    td = create_discriminator(SIZE, channel_multiplier=1, device="cpu")
    td.load_state_dict(state_dict_to_torch(discriminator_state_from_jax(jv)))
    return jd, jv, td


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("batch", [4, 3, 6, 5])
def test_realism_scores_match_jax(batch, discriminators):
    jd, jv, td = discriminators
    x = _images(batch, batch)
    want = jax.jit(lambda v, im: j_realism_scores(jd, v, im))(jv, jnp.asarray(x))
    with torch.no_grad():
        got = realism_scores(td, torch.from_numpy(x))
    assert tuple(got.shape) == (batch,)
    _close(got.numpy(), want)
    # the stddev statistic ties the samples of a group together
    with torch.no_grad():
        alone = realism_scores(td, torch.from_numpy(x[:1]))
    assert batch == 5 or not np.isclose(alone.item(), got[0].item(), rtol=1e-6)


def _synthetic_ada_d(size=SIZE, ch=512):
    """ada-layout D tensor dict for the 32^2 shapes (``tests/test_ada_pkl.py``)."""
    rng = np.random.RandomState(3)
    t = {f"b{size}.fromrgb.weight": rng.randn(ch, 3, 1, 1).astype(np.float32),
         f"b{size}.fromrgb.bias": rng.randn(ch).astype(np.float32)}
    res = size
    while res > 4:
        t[f"b{res}.conv0.weight"] = rng.randn(ch, ch, 3, 3).astype(np.float32)
        t[f"b{res}.conv0.bias"] = rng.randn(ch).astype(np.float32)
        t[f"b{res}.conv1.weight"] = rng.randn(ch, ch, 3, 3).astype(np.float32)
        t[f"b{res}.conv1.bias"] = rng.randn(ch).astype(np.float32)
        t[f"b{res}.skip.weight"] = rng.randn(ch, ch, 1, 1).astype(np.float32)
        t[f"b{res}.resample_filter"] = np.ones((4, 4), np.float32)  # not read
        res //= 2
    t["b4.conv.weight"] = rng.randn(ch, ch + 1, 3, 3).astype(np.float32)
    t["b4.conv.bias"] = rng.randn(ch).astype(np.float32)
    t["b4.fc.weight"] = rng.randn(ch, ch * 16).astype(np.float32)
    t["b4.fc.bias"] = rng.randn(ch).astype(np.float32)
    t["b4.out.weight"] = rng.randn(1, ch).astype(np.float32)
    t["b4.out.bias"] = rng.randn(1).astype(np.float32)
    return t


def test_ada_tensors_give_jax_scores(discriminators, tmp_path):
    """ada tensors, straight and through a pickle each package reads with
    its own permissive loader: the same scores. The port loads ``b4.fc``
    unpermuted (both flatten NCHW); JAX permutes it to its NHWC flatten."""
    jd, _, _ = discriminators
    tensors = _synthetic_ada_d()
    path = tmp_path / "ffhq_like.pkl"
    with open(path, "wb") as f:
        pickle.dump({"D": {k: torch.from_numpy(v) for k, v in tensors.items()}, "G": {}}, f)
    x = _images(4, 7)
    want = j_realism_scores(jd, jax.tree.map(jnp.asarray,
                                             convert_ada_discriminator(tensors, jd)),
                            jnp.asarray(x))
    for src in (tensors, t_ada.load_network_pkl_tensors(str(path))["D"]):
        td = load_ada_discriminator(src, create_discriminator(SIZE, channel_multiplier=1,
                                                              device="cpu", seed=9))
        with torch.no_grad():
            _close(realism_scores(td, torch.from_numpy(x)).numpy(), want)
    assert set(j_ada.load_network_pkl_tensors(str(path))["D"]) == set(tensors)


def test_ada_loader_raises_on_a_missing_tensor():
    tensors = _synthetic_ada_d()
    del tensors["b16.skip.weight"]
    with pytest.raises(KeyError, match="b16.skip.weight"):
        load_ada_discriminator(tensors, create_discriminator(SIZE, channel_multiplier=1,
                                                             device="cpu"))


class _FakeModule:
    """A pickled torch-like module: private parameter dicts and a cycle."""

    def __init__(self):
        self._parameters = {"weight": np.ones((4, 3)), "bias": np.zeros(4)}
        self._buffers = {"filt": torch.ones(2)}
        self._modules = {"sub": None}
        self.extra = [np.full((2,), 7.0)]
        self.me = self


def test_collect_tensors_matches_jax():
    obj = {"D": _FakeModule(), "meta": "x"}
    got, want = t_ada.collect_tensors(obj), j_ada.collect_tensors(obj)
    assert set(got) == set(want) == {"D.weight", "D.bias", "D.filt", "D.extra.0"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("shape", [(2, 16, 16, 4), (1, 9, 7, 3)])
def test_downsample_2x_matches_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_downsample_2x(jnp.asarray(x)))
    got = downsample_2x(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

"""Parity of the port's Carlini-Wagner attack with the JAX package's
``make_cw``, CPU, float32, on the runner's tiny ViT (`runner.py:105-108`)
carried across with ``vit_state_from_jax``.

The ViT is used because its pixel gradient is dense: Adam's first step is
``lr * g / (|g| + eps)``, so a pixel whose gradient is rounding noise (one a
ResNet's max pool never selects) would move by +-lr on a coin flip of
rounding in either package.

- a run where no iterate meets the margin: ``best_adv`` is the input bit
  for bit and ``best_l2`` is ``inf``, in both packages;
- a run where some do: ``best_l2`` to rtol 1e-5 and ``best_adv`` to 1e-5;
  in both runs every step's margin ``f`` is asserted farther than 1e-3 from
  0, so that rounding cannot decide a success;
- the bookkeeping on a width-8 ResNet (the chip's classifier): wherever
  ``best_l2`` is finite it is ``sum((best_adv - images)^2)``; elsewhere
  ``best_adv`` is the input; the Adam step is ``fused_adam``'s plain twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_pipelines import np_tree, one_torch_thread  # noqa: F401
from tpufusion.attacks.cw import CWConfig as JCWConfig
from tpufusion.attacks.cw import make_cw as j_make_cw
from tpufusion.models import classifiers as jc
from tpufusion_torch.attacks.cw import CWConfig, make_cw
from tpufusion_torch.io.convert import state_dict_to_torch, vit_state_from_jax
from tpufusion_torch.models import classifiers as tc
from tpufusion_torch.models.resnet import ResNet

TINY_VIT = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64)
MARGIN = 1e-3  # the closest any step's f may come to 0


@pytest.fixture(scope="module")
def vit():
    j_fn, jv = jc.create_vit_classifier(8, seed=5, **TINY_VIT)
    jv = np_tree(jv)
    t_fn, tm = tc.create_vit_classifier(8, device="cpu", **TINY_VIT)
    tm.load_state_dict(state_dict_to_torch(vit_state_from_jax(jv)))
    x = np.random.default_rng(31).uniform(-0.8, 0.8, (4, 32, 32, 3)).astype(np.float32)
    labels = np.array(jnp.argmax(jax.jit(j_fn)(jv, jnp.asarray(x)), -1))
    return j_fn, jv, t_fn, tm, x, labels


def _margins(logits, labels):
    one_hot = F.one_hot(labels.long(), logits.shape[-1]).float()
    real = (one_hot * logits).sum(-1)
    other = ((1 - one_hot) * logits - one_hot * 1e9).amax(-1)
    return real - other


def _run_both(vit, cfg_kw):
    j_fn, jv, t_fn, tm, x, labels = vit
    adv_j, l2_j = j_make_cw(lambda im, p: j_fn(p, im), JCWConfig(**cfg_kw))(
        jnp.asarray(x), jnp.asarray(labels), jv)
    seen = []

    def recording(im, model):
        logits = t_fn(model, im)
        seen.append(logits.detach())
        return logits

    lt = torch.from_numpy(labels)
    adv_t, l2_t = make_cw(recording, CWConfig(**cfg_kw))(torch.from_numpy(x), lt, tm)
    f = torch.stack([_margins(lg, lt) for lg in seen])  # (steps, N)
    assert f.shape == (cfg_kw["steps"], x.shape[0])
    assert f.abs().min() > MARGIN, f.abs().min()
    return np.asarray(adv_j), np.asarray(l2_j), adv_t.numpy(), l2_t.numpy(), f


def test_no_success_keeps_the_images(vit):
    *_, x, _ = vit
    adv_j, l2_j, adv_t, l2_t, f = _run_both(vit, dict(c=1e-4, steps=6, lr=1e-4))
    assert (f > 0).all()
    assert np.isinf(l2_j).all() and np.isinf(l2_t).all()
    np.testing.assert_array_equal(adv_t, x)
    np.testing.assert_array_equal(adv_j, x)


def test_successes_match_jax(vit):
    *_, x, _ = vit
    adv_j, l2_j, adv_t, l2_t, f = _run_both(vit, dict(c=10.0, steps=12, lr=0.02))
    won = np.isfinite(l2_t)
    assert won.any() and (f <= 0).any()
    np.testing.assert_array_equal(won, np.isfinite(l2_j))
    np.testing.assert_allclose(l2_t[won], l2_j[won], rtol=1e-5)
    np.testing.assert_allclose(adv_t, adv_j, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(adv_t[~won], x[~won])


def test_config_defaults_match_jax():
    import dataclasses

    assert dataclasses.asdict(CWConfig()) == dataclasses.asdict(JCWConfig())


def test_bookkeeping_on_a_resnet():
    """Wherever an image succeeded, ``best_l2`` is the L2 of its
    ``best_adv``; elsewhere ``best_adv`` is the image; pixels in range."""
    model = ResNet(2, width=8, device="cpu", generator=torch.Generator().manual_seed(4))
    model.requires_grad_(False)
    fn = tc.resnet_logits_fn(32)
    x = torch.rand((4, 48, 48, 3), generator=torch.Generator().manual_seed(5)) * 1.6 - 0.8
    with torch.no_grad():
        labels = fn(model, x).argmax(-1)
    adv, l2 = make_cw(lambda im, m: fn(m, im), CWConfig(c=100.0, steps=10))(x, labels, model)
    won = torch.isfinite(l2)
    assert won.any()
    torch.testing.assert_close(l2[won], ((adv - x) ** 2).sum(dim=(1, 2, 3))[won],
                               rtol=1e-5, atol=0)
    assert torch.equal(adv[~won], x[~won])
    assert adv.min() >= -1 and adv.max() <= 1

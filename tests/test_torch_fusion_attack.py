"""Parity of the port's fusion attack (the slice's main path) with the JAX
package, on the tiny 32^2 test pipeline (``tpufusion.pipeline.
create_test_pipeline``) whose weights are carried into the port.

- the arithmetic fused image matches ``make_fused_image_fn(pipeline,
  "arithmetic")``;
- one PGD step from a shared numpy start (``external_start=True``): the loss
  matches (atol = rtol = 2e-4), the input gradient matches to rtol 1e-3 of its
  largest entry, and ``adv`` matches wherever |grad| > 1e-6 (``sign`` of float
  noise diverges elsewhere);
- 5 port steps descend the loss and stay in the eps-ball; FGSM stays in it;
- the ``'vgg'`` objective (VGG16 perceptual distance of the pooled fused
  image and target): loss and input gradient match JAX's.
CPU, float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tpufusion.attacks.fusion_attack import make_fused_image_fn as j_fused_fn
from tpufusion.attacks.pgd import PGDConfig as JPGDConfig
from tpufusion.attacks.pgd import make_pgd as j_make_pgd
from tpufusion.core.imaging import avg_pool as j_avg_pool
from tpufusion.models.vgg16 import perceptual_distance as j_perceptual_distance
from tpufusion.pipeline import create_test_pipeline
from tpufusion_torch.attacks.pgd import make_pgd
from tpufusion_torch.attacks.fusion_attack import (
    FusionAttackConfig,
    fgsm_on_fusion,
    make_fused_image_fn,
    make_fusion_attack,
    make_fusion_loss,
)
from tpufusion_torch.io.convert import (
    encoder_state_from_jax,
    generator_state_from_jax,
    state_dict_to_torch,
    vgg_state_from_jax,
)
from tpufusion_torch.pipeline import FusionPipeline

TOL = dict(atol=2e-4, rtol=2e-4)
EPS, ALPHA = 16 / 255, 0.02


@pytest.fixture(scope="module")
def pipelines():
    jp = create_test_pipeline("ffhq", jax.random.key(0), size=32)
    tp = FusionPipeline.create(
        "ffhq", size=32, channel_multiplier=1, encoder_base_channels=16,
        encoder_units=(1, 1, 1, 1), encoder_input_size=32, mean_latent_samples=8,
        device="cpu", seed=0)
    tp.generator.load_state_dict(state_dict_to_torch(generator_state_from_jax(
        jax.tree.map(np.asarray, jp.drawer.gen_vars), 32, 1)))
    tp.encoder.load_state_dict(state_dict_to_torch(encoder_state_from_jax(
        jax.tree.map(np.asarray, jp.enc_vars), (1, 1, 1, 1))))
    tp.vgg.load_state_dict(state_dict_to_torch(vgg_state_from_jax(
        jax.tree.map(np.asarray, jp.vgg_vars))))
    tp.latent_avg = torch.from_numpy(np.array(jp.latent_avg))
    tp.drawer.mean_latent = torch.from_numpy(np.array(jp.drawer.mean_latent))
    params = dict(enc=jp.enc_vars, gen=jp.drawer.gen_vars, blend=jp.drawer.blend_params,
                  vgg=jp.vgg_vars)
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    start = np.clip(x + rng.uniform(-EPS, EPS, x.shape), -1, 1).astype(np.float32)
    return jp, tp, params, x, target, start


def test_fused_image_matches_jax(pipelines):
    jp, tp, params, x, _, _ = pipelines
    f_j = jax.jit(j_fused_fn(jp, "arithmetic"))(params, jnp.asarray(x))
    with torch.no_grad():
        f_t = make_fused_image_fn(tp)(torch.from_numpy(x))
    assert tuple(f_t.shape) == (1, 32, 32, 3)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **TOL)
    with torch.no_grad():
        codes = tp.get_latents(torch.from_numpy(x))
    np.testing.assert_allclose(codes.numpy(), np.asarray(jp.get_latents(jnp.asarray(x))),
                               **TOL)


def test_one_pgd_step_from_shared_start_matches_jax(pipelines):
    jp, tp, params, x, target, start = pipelines
    fused_j = j_fused_fn(jp, "arithmetic")

    def j_loss(adv, params_, tgt):  # the JAX attack's pixel objective
        d = fused_j(params_, adv).astype(jnp.float32) - tgt.astype(jnp.float32)
        return jnp.mean(d * d)

    jcfg = JPGDConfig(eps=EPS, alpha=ALPHA, steps=1, targeted=True)
    adv_j, tr_j = j_make_pgd(j_loss, jcfg, external_start=True)(
        jnp.asarray(x), jnp.asarray(start), params, jnp.asarray(target))
    g_j = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(start), params,
                                               jnp.asarray(target)))

    cfg = FusionAttackConfig()
    cfg = dataclasses.replace(cfg, pgd=dataclasses.replace(cfg.pgd, eps=EPS, alpha=ALPHA,
                                                           steps=1))
    xt, tt, st = map(torch.from_numpy, (x, target, start))
    loss_t = make_fusion_loss(tp, cfg)
    pgd_cfg = dataclasses.replace(cfg.pgd, targeted=cfg.targeted)
    adv_t, tr_t = make_pgd(loss_t, pgd_cfg, external_start=True)(xt, st, tt)
    s_req = st.clone().requires_grad_(True)
    (g_t,) = torch.autograd.grad(loss_t(s_req, tt), s_req)

    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), **TOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-3 * np.abs(g_j).max())
    mask = np.abs(g_j) > 1e-6
    assert mask.mean() > 0.5
    np.testing.assert_allclose(adv_t.numpy()[mask], np.asarray(adv_j)[mask], atol=1e-6,
                               rtol=0)


def test_five_steps_descend_and_stay_in_ball(pipelines):
    _, tp, _, x, target, _ = pipelines
    cfg = FusionAttackConfig()
    cfg = dataclasses.replace(cfg, pgd=dataclasses.replace(cfg.pgd, steps=5))
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    adv, trace = make_fusion_attack(tp, cfg)(xt, tt, torch.Generator().manual_seed(0))
    assert trace.shape == (5,) and torch.isfinite(trace).all()
    with torch.no_grad():
        final = make_fusion_loss(tp, cfg)(adv, tt)
    assert final < trace[0]
    assert (adv - xt).abs().max() <= cfg.pgd.eps + 1e-6
    assert adv.min() >= -1 and adv.max() <= 1


def test_fgsm_stays_in_ball(pipelines):
    _, tp, _, x, target, _ = pipelines
    xt = torch.from_numpy(x)
    adv, trace = fgsm_on_fusion(tp, eps=EPS)(xt, torch.from_numpy(target))
    assert trace.shape == (1,)
    assert (adv - xt).abs().max() <= EPS + 1e-6
    assert not torch.equal(adv, xt)


def test_vgg_objective_matches_jax(pipelines):
    jp, tp, params, x, target, start = pipelines
    fused_j, vgg_j, factor = j_fused_fn(jp, "arithmetic"), jp.vgg_fn(), jp.pool_factor

    def j_loss(adv, params_, tgt):  # the JAX attack's 'vgg' objective
        fa = vgg_j(params_["vgg"], j_avg_pool(fused_j(params_, adv), factor))
        fb = vgg_j(params_["vgg"], j_avg_pool(tgt, factor))
        return j_perceptual_distance(fa, fb)

    loss_j, g_j = jax.jit(jax.value_and_grad(j_loss))(jnp.asarray(start), params,
                                                      jnp.asarray(target))
    g_j = np.asarray(g_j)
    loss_fn = make_fusion_loss(tp, FusionAttackConfig(objective="vgg"))
    s_req = torch.from_numpy(start).requires_grad_(True)
    loss = loss_fn(s_req, torch.from_numpy(target))
    (g,) = torch.autograd.grad(loss, s_req)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_j), **TOL)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=0, atol=1e-3 * np.abs(g_j).max())


def test_unported_modes_name_their_roadmap_item(pipelines):
    """Every mode and objective is ported: spatial fusion builds and asks
    for the dataset's role count (ffhq: 5, these are 2 inputs); unknown
    modes and objectives raise."""
    _, tp, _, x, _, _ = pipelines
    with pytest.raises(ValueError, match="needs 5 latents, got 2"):
        make_fused_image_fn(tp, "spatial")(torch.from_numpy(x))
    attack = make_fusion_attack(tp, FusionAttackConfig(mode="spatial", objective="vgg"))
    assert callable(attack)
    with pytest.raises(ValueError):
        make_fused_image_fn(tp, "blend")
    with pytest.raises(ValueError):
        make_fusion_loss(tp, FusionAttackConfig(objective="lpips"))


@pytest.mark.parametrize("is_cars", [False, True])
def test_latents_with_matches_jax(is_cars):
    """avg-pool by the pool factor, + latent_avg, and the cars 18 -> 16 trim."""
    from tpufusion.pipeline import latents_with as j_latents_with
    from tpufusion_torch.pipeline import latents_with

    rng = np.random.default_rng(11)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    proj = rng.standard_normal((3, 18 * 4)).astype(np.float32)
    latent_avg = rng.standard_normal((18, 4)).astype(np.float32)

    def j_enc(_, x):  # a stand-in encoder: pooled pixels -> (N, 18, 4)
        return (jnp.mean(x, axis=(1, 2)) @ proj).reshape(-1, 18, 4)

    def t_enc(x):
        return (x.mean(dim=(1, 2)) @ torch.from_numpy(proj)).reshape(-1, 18, 4)

    want = j_latents_with(j_enc, None, jnp.asarray(latent_avg), 4, is_cars,
                          jnp.asarray(images))
    got = latents_with(t_enc, torch.from_numpy(latent_avg), 4, is_cars,
                       torch.from_numpy(images))
    assert tuple(got.shape) == (2, 16 if is_cars else 18, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

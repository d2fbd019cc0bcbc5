"""Parity of the port's spatial-fusion attack and its partial-fusion
evaluation with the JAX package, on the tiny 32^2 test pipeline
(``tpufusion.pipeline.create_test_pipeline``) whose weights, fusion nets
included, are carried into the port. One JAX test pipeline serves every
test of the file.

Attack:
- the spatial fused image of N = 5 inputs matches ``make_fused_image_fn(jp,
  'spatial')`` (atol = rtol = 2e-4);
- one PGD step from a shared start, for the ``'pixel'`` and the ``'vgg'``
  objective: the loss matches (2e-4), the input gradient matches to rtol
  1e-3 of its largest entry (as ``tests/test_torch_fusion_attack.py`` does
  for arithmetic fusion), and the step moves each pixel by -alpha·sign of
  JAX's gradient wherever |grad| > 1e-6;
- FGSM and 3 PGD steps on the spatial fusion stay in the eps-ball and the
  loss falls; N != 5 raises ``ValueError``.
Evaluation (``tpufusion/eval``):
- ``partial_latent_variants`` exactly; ``partial_adv_fusion`` and
  ``benign_fusion`` in both modes (2e-4); the batched spatial partial
  equals a loop over its N+1 variants (1e-5);
- the metrics on random images: MSE and latent distance to rel 1e-6, SSIM
  to 1e-5, ``fused_image_metrics`` to 2e-4; numpy inputs go to the device
  asked for, tensors stay where they lie.
CPU, float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufusion.attacks.fusion_attack import make_fused_image_fn as j_fused_fn
from tpufusion.core.imaging import avg_pool as j_avg_pool
from tpufusion.eval import metrics as jm
from tpufusion.eval import partial as jpart
from tpufusion.models.vgg16 import perceptual_distance as j_perceptual_distance
from tpufusion.pipeline import create_test_pipeline
from tpufusion_torch.attacks.fusion_attack import (
    FusionAttackConfig,
    fgsm_on_fusion,
    make_fused_image_fn,
    make_fusion_attack,
    make_fusion_loss,
)
from tpufusion_torch.attacks.pgd import make_pgd
from tpufusion_torch.eval import (
    benign_fusion,
    fused_image_metrics,
    input_noise_mse,
    latent_distance,
    mse_per_image,
    partial_adv_fusion,
    partial_latent_variants,
    rgb_to_gray,
    ssim,
)
from tpufusion_torch.fusion.spatial import spatial_fused
from tpufusion_torch.io.convert import (
    blender_state_from_jax,
    encoder_state_from_jax,
    generator_state_from_jax,
    state_dict_to_torch,
    vgg_state_from_jax,
)
from tpufusion_torch.pipeline import FusionPipeline

TOL = dict(atol=2e-4, rtol=2e-4)
EPS, ALPHA = 16 / 255, 0.02
N = 5  # the ffhq role count


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The test workers share the machine's cores: one intra-op thread per
    worker keeps these 32^2 runs from oversubscribing them (restored after
    the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_of(jp):
    """The port's 32^2 pipeline on the JAX test pipeline's weights."""
    tp = FusionPipeline.create(
        "ffhq", size=32, channel_multiplier=1, encoder_base_channels=16,
        encoder_units=(1, 1, 1, 1), encoder_input_size=32, mean_latent_samples=8,
        device="cpu", seed=0)
    tp.generator.load_state_dict(state_dict_to_torch(generator_state_from_jax(
        _np(jp.drawer.gen_vars), 32, 1)))
    tp.encoder.load_state_dict(state_dict_to_torch(encoder_state_from_jax(
        _np(jp.enc_vars), (1, 1, 1, 1))))
    tp.vgg.load_state_dict(state_dict_to_torch(vgg_state_from_jax(_np(jp.vgg_vars))))
    tp.drawer.blender.load_state_dict(state_dict_to_torch(blender_state_from_jax(
        _np(jp.drawer.blend_params))))
    tp.latent_avg = torch.from_numpy(np.array(jp.latent_avg))
    tp.drawer.mean_latent = torch.from_numpy(np.array(jp.drawer.mean_latent))
    return tp


@pytest.fixture(scope="module")
def pipelines():
    jp = create_test_pipeline("ffhq", jax.random.key(0), size=32)
    params = dict(enc=jp.enc_vars, gen=jp.drawer.gen_vars, blend=jp.drawer.blend_params,
                  vgg=jp.vgg_vars)
    rng = np.random.default_rng(21)
    x = rng.uniform(-1, 1, (N, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    start = np.clip(x + rng.uniform(-EPS, EPS, x.shape), -1, 1).astype(np.float32)
    return jp, _port_of(jp), params, x, target, start


def test_spatial_fused_image_matches_jax(pipelines):
    jp, tp, params, x, _, _ = pipelines
    f_j = jax.jit(j_fused_fn(jp, "spatial"))(params, jnp.asarray(x))
    with torch.no_grad():
        f_t = make_fused_image_fn(tp, "spatial")(torch.from_numpy(x))
    assert tuple(f_t.shape) == (1, 32, 32, 3)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **TOL)


def _jax_loss(jp, objective):
    fused_j = j_fused_fn(jp, "spatial")
    if objective == "pixel":
        def loss(adv, params_, tgt):
            d = fused_j(params_, adv).astype(jnp.float32) - tgt.astype(jnp.float32)
            return jnp.mean(d * d)
        return loss
    vgg_j, factor = jp.vgg_fn(), jp.pool_factor

    def loss(adv, params_, tgt):
        fa = vgg_j(params_["vgg"], j_avg_pool(fused_j(params_, adv), factor))
        fb = vgg_j(params_["vgg"], j_avg_pool(tgt, factor))
        return j_perceptual_distance(fa, fb)
    return loss


@pytest.mark.parametrize("objective", ["pixel", "vgg"])
def test_one_pgd_step_from_shared_start_matches_jax(pipelines, objective):
    jp, tp, params, x, target, start = pipelines
    loss_j, g_j = jax.jit(jax.value_and_grad(_jax_loss(jp, objective)))(
        jnp.asarray(start), params, jnp.asarray(target))
    g_j = np.asarray(g_j)

    cfg = FusionAttackConfig(mode="spatial", objective=objective)
    cfg = dataclasses.replace(cfg, pgd=dataclasses.replace(cfg.pgd, eps=EPS, alpha=ALPHA,
                                                           steps=1))
    xt, tt, st = map(torch.from_numpy, (x, target, start))
    loss_t = make_fusion_loss(tp, cfg)
    adv_t, tr_t = make_pgd(loss_t, dataclasses.replace(cfg.pgd, targeted=True),
                           external_start=True)(xt, st, tt)
    s_req = st.clone().requires_grad_(True)
    (g_t,) = torch.autograd.grad(loss_t(s_req, tt), s_req)

    np.testing.assert_allclose(tr_t.numpy(), [float(loss_j)], **TOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-3 * np.abs(g_j).max())
    mask = np.abs(g_j) > 1e-6
    assert mask.mean() > 0.5
    want = np.clip(np.clip(start - ALPHA * np.sign(g_j), x - EPS, x + EPS), -1, 1)
    np.testing.assert_allclose(adv_t.numpy()[mask], want[mask], atol=1e-6, rtol=0)


def test_spatial_attack_descends_and_stays_in_ball(pipelines):
    _, tp, _, x, target, _ = pipelines
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    cfg = FusionAttackConfig(mode="spatial")
    cfg = dataclasses.replace(cfg, pgd=dataclasses.replace(cfg.pgd, steps=3))
    adv, trace = make_fusion_attack(tp, cfg)(xt, tt, torch.Generator().manual_seed(0))
    with torch.no_grad():
        final = make_fusion_loss(tp, cfg)(adv, tt)
    assert trace.shape == (3,) and torch.isfinite(trace).all() and final < trace[0]
    assert (adv - xt).abs().max() <= cfg.pgd.eps + 1e-6
    adv1, tr1 = fgsm_on_fusion(tp, eps=EPS, mode="spatial")(xt, tt)
    assert tr1.shape == (1,) and (adv1 - xt).abs().max() <= EPS + 1e-6
    assert not torch.equal(adv1, xt)


def test_spatial_needs_the_role_count(pipelines):
    _, tp, _, x, target, _ = pipelines
    fused = make_fused_image_fn(tp, "spatial")
    with pytest.raises(ValueError, match="needs 5 latents, got 4"):
        fused(torch.from_numpy(x[:4]))
    with pytest.raises(ValueError, match="needs 5"):
        fgsm_on_fusion(tp, mode="spatial")(torch.from_numpy(x[:2]), torch.from_numpy(target))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

MODES = ("spatial", "arithmetic")


@pytest.fixture(scope="module")
def setup(pipelines):
    jp, tp = pipelines[:2]
    rng = np.random.default_rng(31)
    latent_avg = np.asarray(jp.latent_avg)
    clean = (latent_avg + 0.5 * rng.standard_normal((5, 8, 512))).astype(np.float32)
    adv = (clean + 0.3 * rng.standard_normal(clean.shape)).astype(np.float32)
    return jp, tp, clean, adv


def test_partial_latent_variants_match_jax(setup):
    _, _, clean, adv = setup
    want = np.asarray(jpart.partial_latent_variants(jnp.asarray(clean), jnp.asarray(adv)))
    got = partial_latent_variants(torch.from_numpy(clean), torch.from_numpy(adv))
    assert tuple(got.shape) == (6, 5, 8, 512)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_partial_and_benign_fusion_match_jax(setup, mode):
    jp, tp, clean, adv = setup
    want = jpart.partial_adv_fusion(jp.drawer, jnp.asarray(clean), jnp.asarray(adv), mode)
    with torch.no_grad():
        got = partial_adv_fusion(tp.drawer, clean, adv, mode)
    assert tuple(got.shape) == (6, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jpart.benign_fusion(jp.drawer, jnp.asarray(clean), mode)
    with torch.no_grad():
        got = benign_fusion(tp.drawer, torch.from_numpy(clean), mode)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_batched_spatial_partial_equals_the_variant_loop(setup):
    _, tp, clean, adv = setup
    with torch.no_grad():
        batched = partial_adv_fusion(tp.drawer, clean, adv, "spatial")
        variants = partial_latent_variants(torch.from_numpy(clean), torch.from_numpy(adv))
        loop = torch.cat([spatial_fused(tp.drawer, v[None])[0] for v in variants])
    torch.testing.assert_close(batched, loop, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="mode"):
        partial_adv_fusion(tp.drawer, clean, adv, "blend")
    with pytest.raises(ValueError, match="needs 5"):
        partial_adv_fusion(tp.drawer, clean[:4], adv[:4], "spatial")


def _images(seed, n=4):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    return a, b


def test_metrics_match_jax():
    a, b = _images(41)
    for fn, jfn in ((mse_per_image, jm.mse_per_image), (input_noise_mse, jm.input_noise_mse)):
        np.testing.assert_allclose(fn(a, b, device="cpu").numpy(),
                                   np.asarray(jfn(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    rng = np.random.default_rng(42)
    avg = rng.standard_normal((8, 512)).astype(np.float32)
    lat = rng.standard_normal((3, 8, 512)).astype(np.float32)
    np.testing.assert_allclose(latent_distance(torch.from_numpy(avg), torch.from_numpy(lat)).numpy(),
                               np.asarray(jm.latent_distance(jnp.asarray(avg), jnp.asarray(lat))),
                               rtol=1e-6)
    np.testing.assert_allclose(rgb_to_gray(a, device="cpu").numpy(),
                               np.asarray(jm.rgb_to_gray(jnp.asarray(a))), atol=1e-6, rtol=1e-6)
    got = ssim(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.ssim(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5, rtol=1e-5)
    assert bool(((got >= -1) & (got <= 1)).all())
    same = ssim(torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(same.numpy(), 1.0, atol=1e-5)


def test_fused_image_metrics_match_jax(setup):
    jp, tp, _, _ = setup
    a, b = _images(43, 3)
    want = jm.fused_image_metrics(jp, jnp.asarray(a[:1]), jnp.asarray(b))
    with torch.no_grad():
        got = fused_image_metrics(tp, a[:1], torch.from_numpy(b))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (3,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_inputs_go_to_the_device_asked_for():
    a, b = _images(44, 1)
    assert mse_per_image(a, b, device="cpu").device.type == "cpu"
    assert mse_per_image(torch.from_numpy(a), b).device.type == "cpu"  # the tensor's device

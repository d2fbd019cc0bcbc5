"""Parity of the port's white-box attack with the JAX package, on the tiny
32^2 test pipeline (``tpufusion.pipeline.create_test_pipeline``) whose
generator, encoder and VGG16 weights are carried into the port.

- ``_make_loss``: all 8 terms and ``total`` at a shared ``x``, for both
  presets, and the input gradient (to rtol 1e-3 of its largest entry);
- ``_make_ref``: the no-grad reference bundle;
- ``run_whitebox`` on N = 2 with ``which_adv=[1]`` (JAX stepwise, 3 iters):
  the per-image traces match, row 0 comes back bit-identical and ``adv``
  matches wherever the first step's |g| > 1e-6;
- ``snapshot_every=2, n_iters=5``: the frame count and frames match JAX;
- attacking N images together equals attacking each alone;
- ``grad_accum=2`` equals ``grad_accum=1`` under JAX's own config and bounds
  (``tests/test_attacks.py::test_grad_accum_matches_unchunked``);
- the batch-mean ``make_whitebox_attack`` matches JAX's.
CPU, float32; atol = rtol = 2e-4 unless stated otherwise.

Why ``adv`` is held to 0.02 lr, and the batch-mean run's worst pixel to
0.2 lr: Adam divides each pixel's step by that pixel's own gradient
history, so a gradient error of relative size d moves the pixel by up to
lr * d. The gradients of the two packages differ by up to 1e-3 of their
largest entry, because a few generator pre-activations lie within float32
rounding of the leaky-ReLU kink and take the other slope in one package.
The first step is exact (|g| > 1e-6 keeps lr * g / (|g| + eps) away from
its noise); from the second step a small-gradient pixel inherits the
difference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tpufusion.attacks import whitebox as jwb
from tpufusion.pipeline import create_test_pipeline
from tpufusion_torch.attacks import whitebox as wb
from tpufusion_torch.io.convert import (
    encoder_state_from_jax,
    generator_state_from_jax,
    state_dict_to_torch,
    vgg_state_from_jax,
)
from tpufusion_torch.pipeline import FusionPipeline

TOL = dict(atol=2e-4, rtol=2e-4)
LR = 1e-2
PRESETS = {"attack_main": wb.PRESET_ATTACK_MAIN, "interpolation": wb.PRESET_INTERPOLATION}
J_PRESETS = {"attack_main": jwb.PRESET_ATTACK_MAIN,
             "interpolation": jwb.PRESET_INTERPOLATION}


@pytest.fixture(scope="module")
def pipelines():
    jp = create_test_pipeline("ffhq", jax.random.key(0), size=32)
    tp = FusionPipeline.create(
        "ffhq", size=32, channel_multiplier=1, encoder_base_channels=16,
        encoder_units=(1, 1, 1, 1), encoder_input_size=32, mean_latent_samples=8,
        device="cpu", seed=0)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tp.generator.load_state_dict(state_dict_to_torch(generator_state_from_jax(
        np_tree(jp.drawer.gen_vars), 32, 1)))
    tp.encoder.load_state_dict(state_dict_to_torch(encoder_state_from_jax(
        np_tree(jp.enc_vars), (1, 1, 1, 1))))
    tp.vgg.load_state_dict(state_dict_to_torch(vgg_state_from_jax(np_tree(jp.vgg_vars))))
    params = dict(enc=jp.enc_vars, gen=jp.drawer.gen_vars, vgg=jp.vgg_vars)
    rng = np.random.default_rng(21)
    imgs = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    x = np.clip(imgs + rng.uniform(-0.05, 0.05, imgs.shape), -1, 1).astype(np.float32)
    return jp, tp, params, imgs, target, x


@pytest.fixture(scope="module")
def jax_loss(pipelines):
    """JAX ``_make_loss`` value, terms and input gradient at the shared
    ``x`` per preset, each compiled once."""
    jp, _, params, imgs, target, x = pipelines
    ref = jax.jit(jwb._make_ref(jp))(params, jnp.asarray(imgs), jnp.asarray(target))
    cache = {}

    def get(preset):
        if preset not in cache:
            loss = jwb._make_loss(jp, J_PRESETS[preset])
            (total, terms), g = jax.jit(jax.value_and_grad(loss, argnums=1, has_aux=True))(
                params, jnp.asarray(x), ref)
            cache[preset] = (total, terms, np.asarray(g))
        return cache[preset]

    return ref, get


def _port_loss(tp, imgs, target, x, weights):
    ref = wb._make_ref(tp)(torch.from_numpy(imgs), torch.from_numpy(target))
    xt = torch.from_numpy(x).requires_grad_(True)
    total, terms = wb._make_loss(tp, weights)(xt, ref)
    (g,) = torch.autograd.grad(total, xt)
    return total.detach(), {k: v.detach() for k, v in terms.items()}, g


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_loss_terms_match_jax(pipelines, jax_loss, preset):
    _, tp, _, imgs, target, x = pipelines
    j_total, j_terms, _ = jax_loss[1](preset)
    total, terms, _ = _port_loss(tp, imgs, target, x, PRESETS[preset])
    assert sorted(terms) == sorted(wb.TERMS) == sorted(j_terms)
    for k in wb.TERMS:
        np.testing.assert_allclose(terms[k].numpy(), np.asarray(j_terms[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(total.numpy(), np.asarray(j_total), **TOL)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_input_gradient_matches_jax(pipelines, jax_loss, preset):
    _, tp, _, imgs, target, x = pipelines
    _, _, g_j = jax_loss[1](preset)
    _, _, g = _port_loss(tp, imgs, target, x, PRESETS[preset])
    np.testing.assert_allclose(g.numpy(), g_j, rtol=0, atol=1e-3 * np.abs(g_j).max())


def test_ref_bundle_matches_jax(pipelines, jax_loss):
    _, tp, _, imgs, target, _ = pipelines
    j_ref = jax_loss[0]
    ref = wb._make_ref(tp)(torch.from_numpy(imgs), torch.from_numpy(target))
    assert sorted(ref) == sorted(j_ref)
    for k in ("img_org", "target", "latent_org", "latent_target"):
        np.testing.assert_allclose(ref[k].numpy(), np.asarray(j_ref[k]), **TOL, err_msg=k)
    for k in ("feats_org", "feats_target"):
        assert len(ref[k]) == len(j_ref[k]) == 4
        for a, b in zip(ref[k], j_ref[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=k)


def _first_step_grad(tp, imgs, target):
    """Each image's gradient at the first step (x = img) of the default
    preset, for the |g| > 1e-6 masks."""
    ref = wb._make_ref(tp)(torch.from_numpy(imgs), torch.from_numpy(target))
    x = torch.from_numpy(imgs).requires_grad_(True)
    total, _ = wb._make_loss(tp, wb.PRESET_ATTACK_MAIN, per_image=True)(x, ref)
    return torch.autograd.grad(total.sum(), x)[0].numpy()


@pytest.fixture(scope="module")
def which_adv_runs(pipelines):
    """``run_whitebox`` on N = 2, attacking image 1 only: 3 iters, then 5
    iters with snapshots every 2, by both packages."""
    jp, tp, _, imgs, target, _ = pipelines
    out = {}
    for n_iters, every in ((3, None), (5, 2)):
        jcfg = jwb.WhiteboxConfig(lr=LR, n_iters=n_iters, execution="stepwise",
                                  snapshot_every=every)
        cfg = wb.WhiteboxConfig(lr=LR, n_iters=n_iters, snapshot_every=every)
        out[n_iters] = (
            jwb.run_whitebox(jp, jnp.asarray(imgs), jnp.asarray(target), jcfg, which_adv=[1]),
            wb.run_whitebox(tp, torch.from_numpy(imgs), torch.from_numpy(target), cfg,
                            which_adv=[1]))
    mask = np.abs(_first_step_grad(tp, imgs[1:], target)) > 1e-6
    assert mask.mean() > 0.5
    return out, mask


def test_run_whitebox_which_adv_matches_jax(pipelines, which_adv_runs):
    _, _, _, imgs, _, _ = pipelines
    (j_adv, j_trace), (adv, trace) = which_adv_runs[0][3]
    mask = which_adv_runs[1][0]
    assert sorted(trace) == sorted(j_trace) == sorted(wb.TERMS + ("total",))
    for k, v in trace.items():
        assert tuple(v.shape) == (1, 3) == np.shape(j_trace[k]), k
        np.testing.assert_allclose(v.numpy(), np.asarray(j_trace[k]), **TOL, err_msg=k)
    assert torch.equal(adv[0], torch.from_numpy(imgs[0]))
    np.testing.assert_allclose(adv[1].numpy()[mask], np.asarray(j_adv)[1][mask],
                               atol=0.02 * LR, rtol=0)
    assert (adv[1] - torch.from_numpy(imgs[1])).abs().max() > 0.5 * LR


def test_snapshots_match_jax(which_adv_runs):
    (j_adv, j_trace, j_snaps), (adv, trace, snaps) = which_adv_runs[0][5]
    mask = which_adv_runs[1][0]
    assert sorted(snaps) == ["adv_input", "rec"]
    for k in ("adv_input", "rec"):
        assert isinstance(snaps[k], np.ndarray)
        assert snaps[k].shape == (2, 1, 32, 32, 3) == np.shape(j_snaps[k])
    np.testing.assert_allclose(snaps["adv_input"][:, 0][:, mask],
                               np.asarray(j_snaps["adv_input"])[:, 0][:, mask],
                               atol=0.02 * LR, rtol=0)
    np.testing.assert_allclose(snaps["rec"], np.asarray(j_snaps["rec"]), **TOL)
    np.testing.assert_allclose(trace["total"].numpy(), np.asarray(j_trace["total"]), **TOL)
    # frame 1 is the state after 3 steps: the 3-iteration run's result (up to
    # the CPU's run-to-run float noise, amplified as above; a step is ~lr)
    np.testing.assert_allclose(snaps["adv_input"][0, 0][mask],
                               which_adv_runs[0][3][1][0][1].numpy()[mask],
                               atol=0.02 * LR, rtol=0)


def test_images_are_attacked_independently(pipelines):
    """Attacking both images as one batch gives each image the trajectory it
    has when attacked alone: the backward takes the sum of per-image totals,
    not their mean."""
    _, tp, _, imgs, target, _ = pipelines
    cfg = wb.WhiteboxConfig(lr=LR, n_iters=3)
    both = wb.run_whitebox(tp, torch.from_numpy(imgs), torch.from_numpy(target), cfg)
    mask = np.abs(_first_step_grad(tp, imgs, target)) > 1e-6
    for i in range(2):
        alone = wb.run_whitebox(tp, torch.from_numpy(imgs), torch.from_numpy(target), cfg,
                                which_adv=[i])
        for k, v in alone[1].items():
            np.testing.assert_allclose(both[1][k][i:i + 1].numpy(), v.numpy(), **TOL,
                                       err_msg=k)
        np.testing.assert_allclose(both[0][i].numpy()[mask[i]], alone[0][i].numpy()[mask[i]],
                                   atol=0.02 * LR, rtol=0)


def test_grad_accum_matches_unchunked(pipelines):
    """JAX's config (default lr, 5 iters, snapshots every 2) and bounds, on an
    odd batch whose chunks of 2 pad by wrap. Chunks of 2 and a batch of 3
    reduce in another order, which Adam amplifies as the module docstring
    says: pixels are held where the first step's |g| > 1e-6, all but 0.1% of
    them to JAX's 5e-5 and every one to less than one step (lr)."""
    _, tp, _, imgs, target, _ = pipelines
    odd_np = np.concatenate([imgs, imgs[:1] * 0.5])
    odd = torch.from_numpy(odd_np)
    mask = np.abs(_first_step_grad(tp, odd_np, target)) > 1e-6
    assert mask.mean() > 0.5
    base = wb.WhiteboxConfig(n_iters=5, snapshot_every=2)
    a = wb.run_whitebox(tp, odd, torch.from_numpy(target), base)
    b = wb.run_whitebox(tp, odd, torch.from_numpy(target),
                        dataclasses.replace(base, grad_accum=2))
    assert b[0].shape == odd.shape and tuple(b[1]["total"].shape) == (3, 5)
    lr = base.lr
    for got, want in ((b[0].numpy()[mask], a[0].numpy()[mask]),
                      (b[2]["adv_input"][:, mask], a[2]["adv_input"][:, mask])):
        err = np.abs(got - want)
        assert (err > 5e-5).mean() <= 1e-3 and err.max() < lr, (err.max(), (err > 5e-5).mean())
    np.testing.assert_allclose(b[1]["total"].numpy(), a[1]["total"].numpy(), rtol=2e-5)
    assert b[2]["adv_input"].shape == (2, 3, 32, 32, 3)
    np.testing.assert_allclose(b[2]["rec"], a[2]["rec"], atol=5e-4)


def test_batch_mean_attack_matches_jax(pipelines):
    jp, tp, _, imgs, target, _ = pipelines
    jcfg = jwb.WhiteboxConfig(lr=LR, n_iters=2)
    j_adv, j_trace = jwb.make_whitebox_attack(jp, jcfg)(jnp.asarray(imgs),
                                                       jnp.asarray(target))
    adv, trace = wb.make_whitebox_attack(tp, wb.WhiteboxConfig(lr=LR, n_iters=2))(
        torch.from_numpy(imgs), torch.from_numpy(target))
    for k, v in trace.items():
        assert tuple(v.shape) == (2,) == np.shape(j_trace[k]), k
        np.testing.assert_allclose(v.numpy(), np.asarray(j_trace[k]), **TOL, err_msg=k)
    mask = np.abs(_first_step_grad(tp, imgs, target)) > 1e-6
    assert mask.mean() > 0.5
    err = np.abs(adv.numpy() - np.asarray(j_adv))[mask]
    assert err.max() <= 0.2 * LR and err.mean() <= 1e-5, (err.max(), err.mean())


def test_batch_mean_paths_refuse_grad_accum(pipelines):
    tp = pipelines[1]
    cfg = wb.WhiteboxConfig(grad_accum=2)
    with pytest.raises(ValueError, match="grad_accum"):
        wb.make_whitebox_attack(tp, cfg)
    with pytest.raises(ValueError, match="grad_accum"):
        wb.run_whitebox_stepwise(tp, None, None, cfg)
    assert [wb.default_n_iters(s) for s in (256, 512, 1024)] == [50, 100, 100]
    for name in PRESETS:
        assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(J_PRESETS[name])
    # every field, JAX's executor switch too, with the same default
    fields = {f.name for f in dataclasses.fields(wb.WhiteboxConfig)}
    assert fields == {f.name for f in dataclasses.fields(jwb.WhiteboxConfig)}
    assert wb.WhiteboxConfig() == wb.WhiteboxConfig(
        **{k: getattr(jwb.WhiteboxConfig(), k) for k in fields if k != "weights"},
        weights=wb.PRESET_ATTACK_MAIN)

"""The car family (512^2 generator, 16 W+ rows, N = 4 inputs, ViT surrogate)
through the port, held against the JAX package on the CPU in float32.

The cases of this file that are not car-only are the family cases: the
church file (``tests/test_torch_family_church.py``) imports them and runs
them on its own ``family`` fixture. Each builds its oracles from the JAX
package's ``create_test_pipeline`` at 32^2 (n_latent 8), with the weights
carried into the port by ``port_of_family`` (a family-aware twin of
``tests/torch_pipelines.py::port_of``, on the same converters).

Family cases (atol = rtol = 2e-4, the goldens' bar, unless stated):
- the latents at pool factor 1 and the fused image of both modes;
- ``generator_state_from_jax`` / ``generator_state_to_jax`` round trips
  bit for bit at 32^2 and 64^2 (n_latent 8 and 10);
- ``generate_img`` with the family's keywords (z, so truncation 0.5), the
  swap table's ``car`` row, ``w_plus_to_image``; ``spatial_fusion``'s
  fused image, singles in the body-first order and features;
- one PGD step from JAX's start for both modes and objectives, held as
  ``tests/test_torch_eval.py`` holds it (loss 2e-4, gradient 1e-3 of its
  largest entry, the step on |g| > 1e-6), and FGSM from the inputs;
- ``partial_adv_fusion`` and ``benign_fusion`` of both modes,
  ``fused_image_metrics``;
- ``run_whitebox``, 2 iterations: traces to 2e-4, pixels where the first
  step's |g| > 1e-6 to 0.2 lr and their mean to 1e-5
  (``tests/test_torch_whitebox.py``'s bound for the leaky-ReLU kink);
- ``classifier_for`` (car: the tiny ViT, church: resnet18) on JAX's weights:
  logits and pixel gradients, and the runner's classifier-PGD step from a
  shared start, at the classifier's input size;
- ``transform_for`` of the test and inference splits, exactly;
- ``attack_run --config configs/<family>_whitebox.json --tiny`` of both
  packages on the same images, target and weights: the same run folders
  and parameters, the inputs within 1e-6 (each package's resize), the
  adversarial pixels within 0.2 lr where the first step's sign is the
  gradient's, and the metrics to 2e-4.
Car only: the latents and fused image at pool factor 2 (a 64^2 generator
with a 32^2 encoder), an 18-row encoder's codes cut to 16 rows by
``latents_with`` (kept whole without the cars flag), ``save`` / ``load`` of
a car pipeline across the packages (the spatial fused image, the fusion
nets included), ``train_patch`` with JAX's draws, CW on the ViT
logits and the ``cw`` dispatch, ``invert`` of both packages (the latents
and the 64:448 row crop) and ``fuse``'s car branch.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from tests.test_torch_cw import _margins
from tests.test_torch_patch import _square_draw
from tests.torch_pipelines import np_tree, one_torch_thread  # noqa: F401
from tpufusion import configs as j_configs
from tpufusion import runner as j_runner
from tpufusion.attacks import patch as jpa
from tpufusion.attacks import whitebox as jwb
from tpufusion.attacks.cw import CWConfig as JCWConfig
from tpufusion.attacks.cw import make_cw as j_make_cw
from tpufusion.attacks.fusion_attack import make_fused_image_fn as j_fused_fn
from tpufusion.core.dtypes import Policy as JPolicy
from tpufusion.core.imaging import avg_pool as j_avg_pool
from tpufusion.data import transform_for as j_transform_for
from tpufusion.eval import metrics as jm
from tpufusion.eval import partial as jpart
from tpufusion.fusion.spatial import spatial_fusion as j_spatial_fusion
from tpufusion.models.e4e import create_encoder as j_create_encoder
from tpufusion.models.stylegan2 import create_generator as j_create_generator
from tpufusion.models.vgg16 import perceptual_distance as j_perceptual_distance
from tpufusion.pipeline import FusionPipeline as JPipeline
from tpufusion.pipeline import create_test_pipeline as j_create_test_pipeline
from tpufusion.pipeline import latents_with as j_latents_with
from tpufusion_torch import runner
from tpufusion_torch.attacks import patch as tpa
from tpufusion_torch.attacks import whitebox as wb
from tpufusion_torch.attacks.cw import CWConfig, make_cw
from tpufusion_torch.attacks.fusion_attack import (
    FusionAttackConfig,
    fgsm_on_fusion,
    make_fused_image_fn,
    make_fusion_loss,
)
from tpufusion_torch.attacks.pgd import PGDConfig, make_pgd
from tpufusion_torch.configs import AttackRunConfig
from tpufusion_torch.core.dtypes import Policy
from tpufusion_torch.data import transform_for
from tpufusion_torch.eval import benign_fusion, fused_image_metrics, partial_adv_fusion
from tpufusion_torch.fusion.spatial import spatial_fusion
from tpufusion_torch.io import load_image
from tpufusion_torch.io.convert import (
    blender_state_from_jax,
    encoder_state_from_jax,
    generator_state_from_jax,
    generator_state_to_jax,
    resnet_state_from_jax,
    state_dict_to_torch,
    vgg_state_from_jax,
    vit_state_from_jax,
)
from tpufusion_torch.models.e4e import Encoder4Editing
from tpufusion_torch.models.stylegan2 import Generator
from tpufusion_torch.ops.adam_update import B1, B2
from tpufusion_torch.pipeline import FusionPipeline, latents_with

TOL = dict(atol=2e-4, rtol=2e-4)
EPS, ALPHA = 16 / 255, 0.02
LR = 1e-2  # the white-box lr of tests/test_torch_whitebox.py
ROLES = {"car": 4, "church": 3}  # DATASET_N_DICT
KWARGS = {"car": ("wheels", "bg_top", "bg_bottom"), "church": ("bg_top", "bg_bottom")}
UNITS = (1, 1, 1, 1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_of_family(jp, dataset, size=32, encoder_input_size=None):
    """The port's ``size``^2 ``dataset`` pipeline on the JAX pipeline
    ``jp``'s weights (generator, encoder, VGG, fusion nets, latents)."""
    enc_in = encoder_input_size or size
    tp = FusionPipeline.create(
        dataset, size=size, channel_multiplier=1, encoder_base_channels=16,
        encoder_units=UNITS, encoder_input_size=enc_in, mean_latent_samples=8,
        policy=Policy(), device="cpu", seed=0)
    tp.generator.load_state_dict(state_dict_to_torch(generator_state_from_jax(
        np_tree(jp.drawer.gen_vars), size, 1)))
    tp.encoder.load_state_dict(state_dict_to_torch(encoder_state_from_jax(
        np_tree(jp.enc_vars), UNITS)))
    tp.vgg.load_state_dict(state_dict_to_torch(vgg_state_from_jax(np_tree(jp.vgg_vars))))
    tp.drawer.blender.load_state_dict(state_dict_to_torch(blender_state_from_jax(
        np_tree(jp.drawer.blend_params))))
    tp.latent_avg = torch.from_numpy(np.array(jp.latent_avg))
    tp.drawer.mean_latent = torch.from_numpy(np.array(jp.drawer.mean_latent))
    return tp


@pytest.fixture(scope="module")
def family():
    return "car"


@pytest.fixture(scope="module")
def pipelines(family):
    """The JAX test pipeline of the family at 32^2, the port on its
    weights, JAX's parameter dict and N inputs, a target and a start in the
    eps-ball."""
    n = ROLES[family]
    jp = j_create_test_pipeline(family, jax.random.key(0), size=32)
    params = dict(enc=jp.enc_vars, gen=jp.drawer.gen_vars, blend=jp.drawer.blend_params,
                  vgg=jp.vgg_vars)
    rng = np.random.default_rng(51)
    x = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    start = np.clip(x + rng.uniform(-EPS, EPS, x.shape), -1, 1).astype(np.float32)
    return jp, port_of_family(jp, family), params, x, target, start


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol, **kw)


# ---------------------------------------------------------------------------
# 1. the pipeline: latents, fused images, the 18 -> 16 trim, persistence
# ---------------------------------------------------------------------------

def test_latents_and_fused_images_match_jax(pipelines, family):
    jp, tp, params, x, _, _ = pipelines
    assert tp.pool_factor == jp.pool_factor == 1 and tp.is_cars == jp.is_cars
    with torch.no_grad():
        codes = tp.get_latents(_t(x))
    assert tuple(codes.shape) == (ROLES[family], 8, 512)
    _close(codes, jp.get_latents(jnp.asarray(x)))
    for mode in ("arithmetic", "spatial"):
        want = jax.jit(j_fused_fn(jp, mode))(params, jnp.asarray(x))
        with torch.no_grad():
            got = make_fused_image_fn(tp, mode)(_t(x))
        assert tuple(got.shape) == (1, 32, 32, 3)
        _close(got, want, err_msg=mode)


def test_an_18_row_encoder_is_trimmed_for_cars_only():
    """``latents_with`` on an encoder of 18 styles (the published e4e's) and
    an 18-row latent average: car keeps the first 16 rows, as JAX's does;
    without the cars flag (church, ffhq) all 18 stay."""
    enc_j, vars_j = j_create_encoder(jax.random.key(4), 18, image_size=32, base_channels=16,
                                     unit_counts=UNITS, policy=JPolicy())
    enc = Encoder4Editing(18, base_channels=16, unit_counts=UNITS, input_size=32,
                          policy=Policy(), device="cpu")
    enc.load_state_dict(state_dict_to_torch(encoder_state_from_jax(np_tree(vars_j), UNITS)))
    rng = np.random.default_rng(52)
    images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    avg = rng.standard_normal((18, 512)).astype(np.float32)
    want = j_latents_with(jax.jit(enc_j.apply), vars_j, jnp.asarray(avg), 1, True,
                          jnp.asarray(images))
    with torch.no_grad():
        got = latents_with(enc, _t(avg), 1, True, _t(images))
        whole = latents_with(enc, _t(avg), 1, False, _t(images))
    assert tuple(got.shape) == np.shape(want) == (2, 16, 512)
    _close(got, want)
    assert tuple(whole.shape) == (2, 18, 512) and torch.equal(whole[:, :16], got)


def test_save_and_load_cross_the_packages(pipelines, family, tmp_path):
    """A port ``save`` loads in JAX and a JAX ``save`` in the port, with the
    same spatial fused image (the fusion nets included); the port's round
    trip is bit-identical."""
    jp, tp, _, x, _, _ = pipelines
    tp.save(str(tmp_path / "port"))
    jp.save(str(tmp_path / "jax"))
    from_port = JPipeline.load(str(tmp_path / "port"))
    from_jax = FusionPipeline.load(str(tmp_path / "jax"), policy=Policy(), device="cpu")
    again = FusionPipeline.load(str(tmp_path / "port"), policy=Policy(), device="cpu")
    assert from_port.dataset == from_jax.dataset == family
    j_params = dict(enc=from_port.enc_vars, gen=from_port.drawer.gen_vars,
                    blend=from_port.drawer.blend_params, vgg=from_port.vgg_vars)
    want = jax.jit(j_fused_fn(from_port, "spatial"))(j_params, jnp.asarray(x))
    with torch.no_grad():
        ours = make_fused_image_fn(tp, "spatial")(_t(x))
        _close(make_fused_image_fn(from_jax, "spatial")(_t(x)), want)
        assert torch.equal(make_fused_image_fn(again, "spatial")(_t(x)), ours)
    _close(ours, want)


# ---------------------------------------------------------------------------
# 2. the generator converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,n_latent", [(32, 8), (64, 10)])
def test_generator_converters_round_trip_bit_for_bit(pipelines, size, n_latent):
    """Generators at test size (n_latent 8 at 32^2: the family's test
    pipeline's; 10 at 64^2: a fresh one): JAX -> state dict -> JAX and
    state dict -> JAX -> state dict give the same bits."""
    if size == 32:
        variables = pipelines[0].drawer.gen_vars
    else:
        _, variables = j_create_generator(size, jax.random.key(6), channel_multiplier=1,
                                          policy=JPolicy())
    tree = np_tree(variables)
    sd = generator_state_from_jax(tree, size, 1)
    back = generator_state_to_jax(sd, size)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))
    gen = Generator(size, channel_multiplier=1, policy=Policy(), device="cpu")
    gen.load_state_dict(state_dict_to_torch(sd))
    assert gen.n_latent == n_latent
    again = generator_state_from_jax(generator_state_to_jax(gen.state_dict(), size), size, 1)
    assert list(again) == list(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(again[k]), np.asarray(v), err_msg=k)


# ---------------------------------------------------------------------------
# 3-4. the drawer, the hierarchy and spatial fusion
# ---------------------------------------------------------------------------

def _z(seed, n=1):
    return np.random.default_rng(seed).standard_normal((n, 512)).astype(np.float32)


def test_generate_img_with_the_family_keywords(pipelines, family):
    """z latents (the dataset's truncation, 0.5), without and with every
    keyword of the family, and the swap table's ``car`` row."""
    jp, tp, _, _, _, _ = pipelines
    jd, td = jp.drawer, tp.drawer
    assert td.truncation == 0.5
    base = _z(60)
    cases = [{}, {kw: _z(61 + i) for i, kw in enumerate(KWARGS[family])}]
    if family == "car":
        cases.append({"car": _z(65), "wheels": _z(66)})
    for kw in cases:
        img_j, feats_j = jd.generate_img(jnp.asarray(base), latents_type="z",
                                         **{k: jnp.asarray(v) for k, v in kw.items()})
        with torch.no_grad():
            img_t, feats_t = td.generate_img(_t(base), latents_type="z",
                                             **{k: _t(v) for k, v in kw.items()})
        _close(img_t, img_j, err_msg=str(sorted(kw)))
        _close(feats_t[-1], feats_j[-1], err_msg=str(sorted(kw)))


def test_w_plus_to_image_and_spatial_fusion_match_jax(pipelines, family):
    """``w_plus_to_image`` of N rows, and ``spatial_fusion``: the fused image,
    the singles in the body-first reconstruction order and the features."""
    jp, tp, _, x, _, _ = pipelines
    rng = np.random.default_rng(62)
    w = (np.asarray(jp.latent_avg) + 0.5 * rng.standard_normal(
        (ROLES[family], 8, 512))).astype(np.float32)
    img_j, _ = jp.drawer.w_plus_to_image(jnp.asarray(w))
    fused_j, singles_j, feats_j = j_spatial_fusion(jp.drawer, jnp.asarray(w))
    with torch.no_grad():
        img_t, _ = tp.drawer.w_plus_to_image(_t(w))
        fused_t, singles_t, feats_t = spatial_fusion(tp.drawer, _t(w))
    _close(img_t, img_j)
    _close(fused_t, fused_j)
    _close(singles_t, singles_j)
    _close(feats_t, feats_j)
    # body (the last role) first, then the other roles in their order
    order = [ROLES[family] - 1] + list(range(ROLES[family] - 1))
    _close(singles_t, img_t[order])


# ---------------------------------------------------------------------------
# 5. the fusion attack
# ---------------------------------------------------------------------------

def _jax_loss(jp, mode, objective):
    fused_j = j_fused_fn(jp, mode)
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


@pytest.mark.parametrize("mode,objective", [("arithmetic", "pixel"), ("arithmetic", "vgg"),
                                            ("spatial", "pixel"), ("spatial", "vgg")])
def test_pgd_step_and_fgsm_match_jax(pipelines, mode, objective):
    """One PGD step from JAX's start (``external_start=True``) and FGSM from
    the inputs, each against JAX's loss and gradient at that point."""
    jp, tp, params, x, target, start = pipelines
    value_and_grad = jax.jit(jax.value_and_grad(_jax_loss(jp, mode, objective)))
    cfg = FusionAttackConfig(mode=mode, objective=objective)
    cfg = dataclasses.replace(cfg, pgd=dataclasses.replace(cfg.pgd, eps=EPS, alpha=ALPHA,
                                                           steps=1))
    xt, tt, st = _t(x), _t(target), _t(start)
    loss_t = make_fusion_loss(tp, cfg)
    for origin, step_fn in (
            (start, lambda: make_pgd(loss_t, dataclasses.replace(cfg.pgd, targeted=True),
                                     external_start=True)(xt, st, tt)),
            (x, lambda: fgsm_on_fusion(tp, eps=EPS, mode=mode, objective=objective)(xt, tt))):
        loss_j, g_j = value_and_grad(jnp.asarray(origin), params, jnp.asarray(target))
        g_j = np.asarray(g_j)
        o_req = _t(origin).requires_grad_(True)
        (g_t,) = torch.autograd.grad(loss_t(o_req, tt), o_req)
        adv, trace = step_fn()
        _close(trace, [float(loss_j)])
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-3 * np.abs(g_j).max())
        mask = np.abs(g_j) > 1e-6
        assert mask.mean() > 0.5
        alpha = ALPHA if origin is start else EPS
        want = np.clip(np.clip(origin - alpha * np.sign(g_j), x - EPS, x + EPS), -1, 1)
        np.testing.assert_allclose(adv.numpy()[mask], want[mask], atol=1e-6, rtol=0)
        assert (adv - xt).abs().max() <= EPS + 1e-6


# ---------------------------------------------------------------------------
# 6. the evaluation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def latents(pipelines, family):
    jp = pipelines[0]
    rng = np.random.default_rng(63)
    clean = (np.asarray(jp.latent_avg) + 0.5 * rng.standard_normal(
        (ROLES[family], 8, 512))).astype(np.float32)
    adv = (clean + 0.3 * rng.standard_normal(clean.shape)).astype(np.float32)
    return clean, adv


@pytest.mark.parametrize("mode", ["spatial", "arithmetic"])
def test_partial_benign_and_metrics_match_jax(pipelines, latents, family, mode):
    jp, tp, _, _, _, _ = pipelines
    clean, adv = latents
    n = ROLES[family]
    want = jpart.partial_adv_fusion(jp.drawer, jnp.asarray(clean), jnp.asarray(adv), mode)
    j_benign = jpart.benign_fusion(jp.drawer, jnp.asarray(clean), mode)
    with torch.no_grad():
        got = partial_adv_fusion(tp.drawer, clean, adv, mode)
        benign = benign_fusion(tp.drawer, _t(clean), mode)
        metrics = fused_image_metrics(tp, benign[0], got)
    assert tuple(got.shape) == (n + 1, 32, 32, 3)
    _close(got, want)
    for a, b in zip(benign, j_benign):
        _close(a, b)
    for g, w in zip(metrics, jm.fused_image_metrics(jp, j_benign[0], want)):
        assert tuple(g.shape) == (n + 1,)
        _close(g, w)


# ---------------------------------------------------------------------------
# 7. the white-box attack
# ---------------------------------------------------------------------------

def test_run_whitebox_matches_jax(pipelines, family):
    """Two iterations on N = 4 (car) or 3 (church) inputs toward one
    target, held as ``tests/test_torch_whitebox.py`` holds the batch-mean
    attack: where the first step's |g| > 1e-6, every pixel within 0.2 lr and
    their mean within 1e-5. Its N = 2 run holds 0.02 lr; on church's inputs
    6 of 9212 such pixels lie at 0.02-0.08 lr, where the second step's
    gradient crosses a leaky-ReLU kink in one package only."""
    jp, tp, _, x, target, _ = pipelines
    jcfg = jwb.WhiteboxConfig(lr=LR, n_iters=2, execution="stepwise")
    j_adv, j_trace = jwb.run_whitebox(jp, jnp.asarray(x), jnp.asarray(target), jcfg)
    adv, trace = wb.run_whitebox(tp, _t(x), _t(target), wb.WhiteboxConfig(lr=LR, n_iters=2))
    assert sorted(trace) == sorted(j_trace)
    for k, v in trace.items():
        assert tuple(v.shape) == (ROLES[family], 2) == np.shape(j_trace[k]), k
        _close(v, j_trace[k], err_msg=k)
    ref = wb._make_ref(tp)(_t(x), _t(target))
    xr = _t(x).requires_grad_(True)
    total, _ = wb._make_loss(tp, wb.PRESET_ATTACK_MAIN, per_image=True)(xr, ref)
    mask = np.abs(torch.autograd.grad(total.sum(), xr)[0].numpy()) > 1e-6
    assert mask.mean() > 0.5
    err = np.abs(adv.numpy() - np.asarray(j_adv))[mask]
    assert err.max() <= 0.2 * LR and err.mean() <= 1e-5, (err.max(), err.mean())
    assert (adv - _t(x)).abs().max() > 0.5 * LR


# ---------------------------------------------------------------------------
# 9. the surrogate classifier and the classifier attacks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def classifiers(pipelines, family):
    """JAX's ``classifier_for`` of the family and the port's on its weights
    (car: the tiny ViT at <= 64^2; church: resnet18, 256^2 inside)."""
    jp, tp = pipelines[:2]
    j_fn, j_vars = j_runner.classifier_for(jp, j_configs.AttackRunConfig(dataset_name=family),
                                           jax.random.key(7))
    j_vars = np_tree(j_vars)
    fn, model = runner.classifier_for(tp, AttackRunConfig(dataset_name=family),
                                      torch.Generator().manual_seed(7))
    convert = vit_state_from_jax if family == "car" else resnet_state_from_jax
    model.load_state_dict(state_dict_to_torch(convert(j_vars)))
    return j_fn, j_vars, fn, model


CLF_SIZE = {"car": 32, "church": 256}  # the surrogate's own input size
# the CE's pixel gradient against JAX's, of its largest entry: (the bound,
# the share of pixels that may exceed it, the bound for those pixels).
# resnet18 on church's inputs: one layer2 ReLU of image 0 has a float64
# pre-activation 1.1e-7 from its kink, which JAX's float32 puts on the
# other side; the pixels behind it (1.2% of the batch) differ by up to
# 1.6e-2 (the port's float32 and float64 runs agree to 1.3e-6; ROADMAP §C)
CLF_GRAD_TOL = {"car": (2e-4, 0.0, 2e-4), "church": (2e-4, 0.02, 2e-2)}


def test_classifier_for_matches_jax(classifiers, family):
    """The logits (2e-4 of the largest entry) and the pixel gradient of
    the CE at the clean labels (``CLF_GRAD_TOL``), and one step of the
    runner's classifier PGD from a shared start: the loss to 2e-4 and the
    step as JAX's wherever JAX's gradient exceeds the two gradients'
    largest difference (so that its sign is JAX's), on N images at the
    classifier's input size (car: the tiny ViT's 32^2; church: resnet18's
    256^2). Upsampled 32^2 images would tie pixels inside resnet18's max
    pools, where float32 rounding picks the pixel the gradient flows to."""
    j_fn, j_vars, fn, model = classifiers
    size = CLF_SIZE[family]
    rng = np.random.default_rng(54)
    x = rng.uniform(-1, 1, (ROLES[family], size, size, 3)).astype(np.float32)
    start = np.clip(x + rng.uniform(-EPS, EPS, x.shape), -1, 1).astype(np.float32)
    assert type(model).__name__ == ("ViTClassifier" if family == "car" else "ResNet")
    logits_j = np.asarray(jax.jit(j_fn)(j_vars, jnp.asarray(x)))
    with torch.no_grad():
        logits = fn(model, _t(x))
    assert logits.shape[-1] == (8 if family == "car" else 2)
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=0,
                               atol=2e-4 * max(1.0, np.abs(logits_j).max()))
    labels = logits_j.argmax(-1)

    def ce_j(adv, variables, lab):
        lg = j_fn(variables, adv).astype(jnp.float32)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(lg), lab[:, None], 1))

    eps, alpha = 8 / 255 * 2, 0.01 * 2  # the runner's doubled recipe
    s = np.clip(start, x - eps, x + eps).astype(np.float32)
    loss_j, g_j = jax.jit(jax.value_and_grad(ce_j))(jnp.asarray(s), j_vars, jnp.asarray(labels))
    g_j = np.asarray(g_j)

    def ce_t(adv, model_, lab):
        return F.cross_entropy(fn(model_, adv).float(), lab)

    lt = _t(labels)
    adv, trace = make_pgd(ce_t, PGDConfig(eps=eps, alpha=alpha, steps=1),
                          external_start=True)(_t(x), _t(s), model, lt)
    sr = _t(s).requires_grad_(True)
    (g_t,) = torch.autograd.grad(ce_t(sr, model, lt), sr)
    _close(trace, [float(loss_j)])
    tol, share, worst = CLF_GRAD_TOL[family]
    err, top = np.abs(g_t.numpy() - g_j), np.abs(g_j).max()
    assert (err > tol * top).mean() <= share and err.max() <= worst * top, (
        (err > tol * top).mean(), err.max() / top)
    mask = np.abs(g_j) > err.max()
    assert mask.mean() > 0.5
    want = np.clip(np.clip(s + alpha * np.sign(g_j), x - eps, x + eps), -1, 1)
    np.testing.assert_allclose(adv.numpy()[mask], want[mask], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# 10. the dataset transforms
# ---------------------------------------------------------------------------

SPLIT_SIZES = {"car": {"test": (512, 512), "inference": (192, 256)},
               "church": {"test": (256, 256), "inference": (256, 256)}}


def test_transforms_match_jax(family):
    """``cars_encode`` / ``church_encode``: the test and inference splits'
    resize and normalisation of the same image, bit for bit (``gt_train``
    flips at random)."""
    rng = np.random.RandomState(3)
    img = Image.fromarray((rng.rand(300, 420, 3) * 255).astype(np.uint8))
    for split, (h, w) in SPLIT_SIZES[family].items():
        got = transform_for(family, split)(img)
        assert got.shape == (h, w, 3) and got.min() >= -1 and got.max() <= 1, split
        np.testing.assert_array_equal(got, j_transform_for(family, split)(img), err_msg=split)


# ---------------------------------------------------------------------------
# 11. attack_run on the family's preset
# ---------------------------------------------------------------------------

def _write_images(directory, n, size, seed):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(
            os.path.join(directory, f"img_{i}.png"))
    return directory


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def cli_runs(pipelines, family, tmp_path_factory):
    """``attack_run --config configs/<family>_whitebox.json --tiny`` of
    both packages on the same images and target, each CLI building the
    shared-weight test pipeline (its ``create_test_pipeline`` replaced by
    one that returns it)."""
    import tpufusion.pipeline as j_pipeline_mod
    import tpufusion_torch.pipeline as t_pipeline_mod
    from tpufusion.cli import attack_run as j_attack_run
    from tpufusion_torch.cli import attack_run

    jp, tp = pipelines[:2]
    root = tmp_path_factory.mktemp(f"cli_{family}")
    images = _write_images(str(root / "images"), ROLES[family], 40, 70)
    target = os.path.join(_write_images(str(root / "target"), 1, 32, 71), "img_0.png")
    argv = ["--config", os.path.join(REPO, "configs", f"{family}_whitebox.json"), "--tiny",
            "--size", "32", "--images_dir", images, "--target_image", target, "--n_iters", "2",
            "--snapshot_every", "0"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(j_pipeline_mod, "create_test_pipeline", lambda *a, **k: jp)
        mp.setattr(t_pipeline_mod, "create_test_pipeline", lambda *a, **k: tp)
        assert j_attack_run.main(argv + ["--save_dir", str(root / "jax")]) == 0
        assert attack_run.main(argv + ["--save_dir", str(root / "port"), "--device", "cpu"]) == 0
    finally:
        mp.undo()
    return root


def test_attack_run_on_the_preset_matches_jax(pipelines, cli_runs, family):
    root = cli_runs
    assert _tree(root / "port") == _tree(root / "jax")
    (run,) = os.listdir(root / "port" / family)
    assert run.startswith(f"0_{family}_white_box_target_2_0.00010")
    port, jax_run = root / "port" / family / run, root / "jax" / family / run
    params = [json.load(open(d / "parameters.json")) for d in (port, jax_run)]
    assert params[0] == params[1]
    assert (params[0]["dataset"], params[0]["dataset size"], params[0]["white-box lr"],
            params[0]["white-box max_iter"]) == (family, 32, 1e-4, 2)
    assert (port / "parameters.txt").read_text() == (jax_run / "parameters.txt").read_text()
    arrays = {}
    for name in ("all_inputs", "all_adv_inputs"):
        got = np.load(port / "adversarial" / f"{name}.npz")["data"]
        want = np.load(jax_run / "adversarial" / f"{name}.npz")["data"]
        assert got.shape == want.shape == (ROLES[family], 32, 32, 3)
        arrays[name] = got, want
    # the inputs: the transform's 512^2 / 256^2 resized to 32^2, each
    # package's bilinear resize within float32 rounding
    np.testing.assert_allclose(*arrays["all_inputs"], rtol=0, atol=1e-6)
    # the white-box pixels (Adam at lr 1e-4, 2 steps) within 0.2 lr where
    # the first step's sign is the gradient's: |g| above the packages'
    # gradient agreement, 1e-3 of its largest entry (a pixel at 1e-4 of it
    # took opposite first steps of lr in the two packages); every pixel
    # within Adam's bound of its input
    x = _t(arrays["all_inputs"][0])
    tp = pipelines[1]
    ref = wb._make_ref(tp)(x, _t(load_image(str(root / "target" / "img_0.png"), 32)))
    xr = x.clone().requires_grad_(True)
    total, _ = wb._make_loss(tp, wb.PRESET_ATTACK_MAIN, per_image=True)(xr, ref)
    g = torch.autograd.grad(total.sum(), xr)[0].numpy()
    mask = np.abs(g) > 1e-3 * np.abs(g).max()
    assert mask.mean() > 0.5
    got, want = arrays["all_adv_inputs"]
    np.testing.assert_allclose(got[mask], want[mask], atol=0.2 * 1e-4, rtol=0)
    bound = 2 * 1e-4 * (1 - B1) / np.sqrt(1 - B2)
    for a in (got, want):
        assert 0 < np.abs(a - x.numpy()).max() <= bound + 1e-6
    rows = [[json.loads(line) for line in open(d / "results.jsonl")] for d in (port, jax_run)]
    assert len(rows[0]) == len(rows[1]) == 1
    for k, v in rows[1][0].items():
        if isinstance(v, (list, float)):
            _close(rows[0][0][k], v, err_msg=k)


# ---------------------------------------------------------------------------
# car only: pool factor 2, patch, CW, invert and fuse
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipelines64():
    """A 64^2 car pipeline (n_latent 10) with a 32^2 encoder: pool factor 2."""
    jp = JPipeline.create("car", jax.random.key(1), size=64, channel_multiplier=1,
                          policy=JPolicy(), mean_latent_samples=32, encoder_base_channels=16,
                          encoder_units=UNITS, encoder_input_size=32)
    x = np.random.default_rng(53).uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    return jp, port_of_family(jp, "car", 64, 32), x


def test_pool_factor_two_matches_jax(pipelines64):
    jp, tp, x = pipelines64
    assert tp.pool_factor == jp.pool_factor == 2 and tp.generator.n_latent == 10
    with torch.no_grad():
        codes = tp.get_latents(_t(x))
        fused = make_fused_image_fn(tp)(_t(x))
    _close(codes, jp.get_latents(jnp.asarray(x)))
    params = dict(enc=jp.enc_vars, gen=jp.drawer.gen_vars, blend=jp.drawer.blend_params,
                  vgg=jp.vgg_vars)
    assert tuple(fused.shape) == (1, 64, 64, 3)
    _close(fused, jax.jit(j_fused_fn(jp))(params, jnp.asarray(x)))


def test_train_patch_on_a_car_pipeline_matches_jax(pipelines):
    """``train_patch`` over 2 car images (max_count 2) with JAX's initial
    patch and draws passed in: the logs to rtol 1e-4, the patch's move to
    1e-3 of its largest entry (``tests/test_torch_patch.py``'s bounds)."""
    jp, tp, _, x, _, _ = pipelines
    key = jax.random.key(11)
    jcfg = jpa.PatchConfig(max_count=2)
    j_logs, logs = [], []
    j_canvas, j_mask = jpa.train_patch(jp, [jnp.asarray(x[i : i + 1]) for i in range(2)], key,
                                       jcfg, log_fn=lambda e, i, tr: j_logs.append(tr))
    key, kinit = jax.random.split(key)
    init = np.asarray(jpa.init_patch_square(32, jcfg.patch_frac, kinit))
    draws = []
    for _ in range(2):
        key, k = jax.random.split(key)
        draws.append(_square_draw(k, 32, init.shape[0]))
    canvas, mask = tpa.train_patch(tp, [_t(x[i : i + 1]) for i in range(2)], None,
                                   tpa.PatchConfig(max_count=2),
                                   log_fn=lambda e, i, tr: logs.append(tr),
                                   init_patch=_t(init), draws=draws)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert len(logs) == len(j_logs) == 2
    for tr, j_tr in zip(logs, j_logs):
        np.testing.assert_allclose(tr, j_tr, rtol=1e-4, atol=0)
    side = init.shape[0]
    lo = (32 - side) // 2
    j_move = np.asarray(j_canvas)[lo : lo + side, lo : lo + side] - init
    assert np.abs(j_move).max() > 0
    np.testing.assert_allclose(canvas.numpy()[lo : lo + side, lo : lo + side] - init, j_move,
                               rtol=0, atol=1e-3 * np.abs(j_move).max())


def test_cw_on_the_vit_logits_matches_jax(pipelines, classifiers):
    """``make_cw`` through the car surrogate (the tiny ViT) on the car
    inputs, at a c where some images succeed and every step's margin lies
    farther than 1e-3 from 0; then the runner's ``cw`` dispatch of both
    packages on the same classifier at the recipe's c 1e-4. The clean
    inputs miss the margin (the labels are their argmax), so with 2 steps
    the iterate after one Adam step is the only candidate. Both
    packages pick the same images, and their pixels lie within 2 lr: at
    the start the L2 term's gradient is the rounding of ``tanh(atanh(x))
    - x``, which the two packages round apart (5e-3 of the largest gradient
    entry at c 1e-4), so at a pixel whose margin gradient is smaller the
    first step ``lr * g / (|g| + eps)`` (|step| < lr in w, and
    |d adv / d w| <= 1) may go either way (ROADMAP §C)."""
    jp, tp, _, x, target, _ = pipelines
    j_fn, j_vars, fn, model = classifiers
    labels = np.asarray(jax.jit(j_fn)(j_vars, jnp.asarray(x))).argmax(-1)
    kw = dict(c=10.0, steps=12, lr=0.02)
    adv_j, l2_j = j_make_cw(lambda im, p: j_fn(p, im), JCWConfig(**kw))(
        jnp.asarray(x), jnp.asarray(labels), j_vars)
    seen = []

    def recording(im, m):
        logits = fn(m, im)
        seen.append(logits.detach())
        return logits

    lt = _t(labels)
    adv, l2 = make_cw(recording, CWConfig(**kw))(_t(x), lt, model)
    f = torch.stack([_margins(lg, lt) for lg in seen])
    assert f.abs().min() > 1e-3, f.abs().min()
    won = np.isfinite(l2.numpy())
    assert won.any()
    np.testing.assert_array_equal(won, np.isfinite(np.asarray(l2_j)))
    np.testing.assert_allclose(l2.numpy()[won], np.asarray(l2_j)[won], rtol=1e-5)
    np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j), atol=1e-5, rtol=0)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(j_runner, "classifier_for", lambda *a: (j_fn, j_vars))
        mp.setattr(runner, "classifier_for", lambda *a: (fn, model))
        j_out = j_runner.dispatch_attack(
            jp, "cw", jnp.asarray(x), jnp.asarray(target),
            j_configs.AttackRunConfig(dataset_name="car", cw_steps=2), jax.random.key(8))
        out = runner.dispatch_attack(tp, "cw", _t(x), _t(target),
                                     AttackRunConfig(dataset_name="car", cw_steps=2),
                                     torch.Generator().manual_seed(8))
    finally:
        mp.undo()
    got, want = out[0].numpy(), np.asarray(j_out[0])
    moved, j_moved = (np.abs(a - x).reshape(len(x), -1).max(1) > 0 for a in (got, want))
    np.testing.assert_array_equal(moved, j_moved)
    assert moved.any()
    np.testing.assert_allclose(got, want, atol=2 * CWConfig().lr, rtol=0)


def test_invert_crops_rows_64_to_448_and_fuse_has_a_car_branch(pipelines, tmp_path):
    """``invert --dataset car`` of both packages on the shared-weight test
    pipeline: the same latents (2e-4) and (S*3/4, S) inversions (rows
    64:448 of 512, scaled to S); ``fuse --dataset car`` swaps wheels,
    bg_top and bg_bottom into the body."""
    import tpufusion.pipeline as j_pipeline_mod
    import tpufusion_torch.pipeline as t_pipeline_mod
    from tpufusion.cli import invert as j_invert
    from tpufusion_torch.cli import fuse, invert

    jp, tp = pipelines[:2]
    images = _write_images(str(tmp_path / "imgs"), 2, 40, 72)
    argv = ["--images_dir", images, "--dataset", "car", "--tiny", "--size", "32", "--batch", "2"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(j_pipeline_mod, "create_test_pipeline", lambda *a, **k: jp)
        mp.setattr(t_pipeline_mod, "create_test_pipeline", lambda *a, **k: tp)
        assert invert.main(argv + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
        assert j_invert.main(argv + ["--save_dir", str(tmp_path / "jax")]) == 0
    finally:
        mp.undo()
    for out in ("port", "jax"):
        inv = tmp_path / out / "inversions"
        assert sorted(os.listdir(inv)) == ["00001.jpg", "00002.jpg"]
        for name in os.listdir(inv):
            assert Image.open(inv / name).size == (32, 24)  # (width, height)
    lat = [np.load(tmp_path / out / "latents.npz")["latents"] for out in ("port", "jax")]
    assert lat[0].shape == (2, 8, 512)
    _close(lat[0], lat[1])
    demo = str(tmp_path / "car.jpg")
    assert fuse.main(["--dataset", "car", "--tiny", "--size", "32", "--device", "cpu",
                      "--out", demo]) == 0
    assert Image.open(demo).size == (6 * 34 + 2, 36)  # 5 parts + the fusion

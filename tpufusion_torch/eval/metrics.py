"""Evaluation metrics (port of ``tpufusion/eval/metrics.py``):

- per-image MSE (``cal_rec_loss``, `attack_main2.py:765-772`; the input-noise
  MSE of `interpolation.py:1406-1408`);
- grayscale SSIM (``cal_SSMI``, `attack_main2.py:823-839`, skimage's
  defaults), on the device;
- the fused-image metric triple MSE / VGG distance / SSIM (``cal_result``,
  `interpolation.py:1076-1091`);
- the latent distance to the average latent (``calculate_distance``,
  `attack_main2.py:501-505`).

Inputs are tensors or arrays (numpy). Each function runs on ``device`` when
it is given, else on the device of its first tensor argument, else on
``cuda``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpufusion_torch.core.dtypes import resolve_device
from tpufusion_torch.core.imaging import avg_pool

# ITU-R 601 luma: the coefficients skimage's rgb2gray applies before the
# reference's SSIM (`attack_main2.py:832-835`)
LUMA = (0.2125, 0.7154, 0.0721)


def as_tensors(device, *xs):
    """``xs`` as tensors on one device: ``device`` when given, else that of
    the first tensor among them, else ``cuda`` (raises without a card)."""
    if device is None:
        device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    dev = resolve_device(device)
    return [torch.as_tensor(x, device=dev) for x in xs]


def mse_per_image(a, b, *, device=None):
    """(N, H, W, C) pairs -> (N,) mean-squared errors."""
    a, b = as_tensors(device, a, b)
    d = a.float() - b.float()
    return (d * d).mean(dim=tuple(range(1, a.dim())))


input_noise_mse = mse_per_image  # `interpolation.py:1406-1408`


def latent_distance(latent_avg, latents, *, device=None):
    """Per-sample mean squared distance of (N, n_latent, 512) codes to the
    (n_latent, 512) average latent (`attack_main2.py:501-505`)."""
    latent_avg, latents = as_tensors(device, latent_avg, latents)
    d = latents.float() - latent_avg[None].float()
    return (d * d).mean(dim=(1, 2))


def rgb_to_gray(x, *, device=None):
    """NHWC rgb -> NHW1 luma, float32."""
    (x,) = as_tensors(device, x)
    return (x.float() @ torch.tensor(LUMA, device=x.device))[..., None]


def _uniform_filter(x, win: int):
    """VALID-window mean filter of NHW1."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), win, stride=1).permute(0, 2, 3, 1)


def ssim(a, b, *, win: int = 7, data_range: float = 2.0, device=None):
    """Structural similarity of grayscale image pairs, skimage's
    ``structural_similarity`` defaults (win 7, uniform window, K1 0.01, K2
    0.03, sample covariance). Inputs NHWC rgb or NHW1; ``data_range=2`` for
    images in [-1, 1]. Returns (N,)."""
    a, b = as_tensors(device, a, b)
    if a.shape[-1] == 3:
        a, b = rgb_to_gray(a), rgb_to_gray(b)
    a, b = a.float(), b.float()
    cov_norm = win * win / (win * win - 1.0)
    ux, uy = _uniform_filter(a, win), _uniform_filter(b, win)
    uxx, uyy = _uniform_filter(a * a, win), _uniform_filter(b * b, win)
    uxy = _uniform_filter(a * b, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    # float32 variance cancellation on near-identical images can push the
    # mean a few 1e-4 past 1 (skimage works in float64): clamp to SSIM's range
    return s.mean(dim=(1, 2, 3)).clamp(-1.0, 1.0)


def perceptual_distance_per_image(feats_a, feats_b):
    """Per-image sum of per-tap MSEs: the (N,) form of
    ``models.vgg16.perceptual_distance``."""
    total = 0.0
    for a, b in zip(feats_a, feats_b):
        d = a.float() - b.float()
        total = total + (d * d).mean(dim=tuple(range(1, a.dim())))
    return total


def fused_image_metrics_with(vgg_apply, vgg_vars, pool_factor: int, original_fused,
                             adv_fused_all):
    """Params-explicit core of ``fused_image_metrics``: the one definition of
    the per-image metric triple, shared with the sharded group evaluation
    (``parallel.sharding.make_sharded_group_eval``) so the two cannot drift
    apart. ``vgg_apply(vgg_vars, pooled_images)`` returns the 4 perceptual
    taps (``vgg_vars`` a module or a parameter dict for it). Runs on the
    device of ``original_fused`` when it is a tensor."""
    orig, adv = as_tensors(None, original_fused, adv_fused_all)
    orig_all = orig.expand_as(adv)
    feats_o = vgg_apply(vgg_vars, avg_pool(orig, pool_factor))
    feats_a = vgg_apply(vgg_vars, avg_pool(adv, pool_factor))
    feats_o = [t.expand((adv.shape[0],) + t.shape[1:]) for t in feats_o]
    return (mse_per_image(orig_all, adv), perceptual_distance_per_image(feats_a, feats_o),
            ssim(orig_all, adv))


def fused_image_metrics(pipeline, original_fused, adv_fused_all):
    """``cal_result`` (`interpolation.py:1076-1091`): each adversarial fused
    image's MSE, VGG perceptual distance and SSIM against the benign fused
    image, on the pipeline's device. Returns three (K,) tensors; one batched
    VGG pass covers the K adversarial images."""
    orig, adv = as_tensors(pipeline.generator.device, original_fused, adv_fused_all)
    return fused_image_metrics_with(lambda vgg, x: vgg(x), pipeline.vgg, pipeline.pool_factor,
                                    orig, adv)

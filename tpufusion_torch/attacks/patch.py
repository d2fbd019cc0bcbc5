"""Adversarial patch attack and its patch utilities (port of
``tpufusion/attacks/patch.py``).

Reference (`code/attack/patch/adversarial_patch.py:26-160`): loop over a
training set; per batch, randomly rotate and place the patch
(``square_transform`` / ``circle_transform``), then an inner loop of
``max_count`` raw gradient-descent steps on the patch that push the encoder
latent of the patched image away from the clean image's (loss
``-l_latent_org_adv``, `:126`; update ``patch -= adv_grad``, `:135`; clamp
to the source image's range, `:138`). The patch is cropped back out between
batches, still rotated, and the trained patch is laid out centred and
unrotated by ``canonical_canvas``.

Random draws: each transform takes a ``torch.Generator`` or the draw itself
(``draw=``): a square's ``(k, (y, x))`` (k quarter turns, then the top-left
corner), a circle's ``(angle, (y, x))``. PyTorch's generators cannot
reproduce the JAX package's threefry draws, so a parity test computes JAX's
draw from its key and passes it in.

The patch step is the e4e encoder's forward and backward, which the JAX
package leaves to XLA; it reaches the hand-written kernels only when a
reconstruction weight is non-zero (the decoder's styled convs and 3x3
convs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import numpy as np
import torch

from tpufusion_torch.core.imaging import avg_pool
from tpufusion_torch.models.vgg16 import perceptual_distance
from tpufusion_torch.ops.composite import masked_composite
from tpufusion_torch.pipeline import FusionPipeline

# ---------------------------------------------------------------------------
# patch init / transform / crop utils
# ---------------------------------------------------------------------------


def patch_side(image_size: int, patch_frac: float) -> int:
    """Square side covering ``patch_frac`` of the image area."""
    return max(int(round(math.sqrt(image_size * image_size * patch_frac))), 1)


def _uniform_patch(side: int, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand((side, side, 3), generator=generator, device=generator.device)
    return u * 2.0 - 1.0


def init_patch_square(image_size: int, patch_frac: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Random square patch, values in [-1, 1] (images are normalised here;
    the reference inits in [0, 1] before normalisation), on the generator's
    device."""
    side = patch_side(image_size, patch_frac)
    if side > image_size:
        raise ValueError(
            f"patch_frac={patch_frac} gives a {side}x{side} square patch "
            f"larger than the {image_size}x{image_size} image "
            f"(patch_frac must be <= 1)")
    return _uniform_patch(side, generator)


def init_patch_circle(image_size: int, patch_frac: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Random circular patch in its bounding square; pixels outside the
    circle are zero (they never enter the mask). ``patch_frac`` must be
    <= pi/4 (~0.785), or the bounding square exceeds the image."""
    radius = int(round(math.sqrt(image_size * image_size * patch_frac / math.pi)))
    side = max(2 * radius, 2)
    if side > image_size:
        raise ValueError(
            f"patch_frac={patch_frac} gives a {side}x{side} bounding square "
            f"larger than the {image_size}x{image_size} image — circle "
            f"patches need patch_frac <= pi/4 (~0.785)")
    patch = _uniform_patch(side, generator)
    return patch * _circle_mask(side, patch.device)


def _circle_mask(side: int, device=None) -> torch.Tensor:
    """(side, side, 1) float32: 1 inside the inscribed circle."""
    c = (side - 1) / 2.0
    r = torch.arange(side, device=device, dtype=torch.float64) - c
    inside = (r[:, None] ** 2 + r[None, :] ** 2) <= (side / 2.0) ** 2
    return inside.to(torch.float32)[..., None]


def _rotate_bilinear(patch: torch.Tensor, angle) -> torch.Tensor:
    """Rotate an HWC patch by ``angle`` radians about its centre, bilinear
    with zero fill: ``map_coordinates(order=1, cval=0)`` of the JAX package
    computed directly in pixel coordinates, with its four neighbours summed
    in its order. The angle is a float32; its cosine and sine are rounded to
    float32 from float64. (``F.grid_sample`` goes through [-1, 1]
    coordinates and drifts from the JAX package by 1.8e-4 at side 578. What
    remains here is the cosine and sine: where XLA's float32 values differ
    from these by an ulp, the sample points move by up to side * 2^-24.)"""
    h, w, _ = patch.shape
    dev = patch.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    angle = torch.as_tensor(angle, dtype=torch.float32, device=dev).double()
    ca, sa = torch.cos(angle).float(), torch.sin(angle).float()
    sy = ca * (yy - cy) - sa * (xx - cx) + cy
    sx = sa * (yy - cy) + ca * (xx - cx) + cx
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    iy, ix = y0.long(), x0.long()
    out = None
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            py, px = iy + dy, ix + dx
            valid = (py >= 0) & (py < h) & (px >= 0) & (px < w)
            v = patch[py.clamp(0, h - 1), px.clamp(0, w - 1)]
            v = torch.where(valid[..., None], v, torch.zeros((), dtype=v.dtype, device=dev))
            term = (wy * wx)[..., None] * v
            out = term if out is None else out + term
    return out


def _placement(pos, image_size: int, side: int):
    y, x = (int(v) for v in pos)
    if not (0 <= y <= image_size - side and 0 <= x <= image_size - side):
        raise ValueError(f"a {side}x{side} patch at {(y, x)} leaves the "
                         f"{image_size}x{image_size} image")
    return y, x


def _draw_pos(generator, image_size: int, side: int):
    pos = torch.randint(0, image_size - side + 1, (2,), generator=generator,
                        device=generator.device)
    return tuple(pos.tolist())


def _place(patch, mask_patch, image_size: int, pos):
    """Full-image ``(canvas, mask)`` holding ``patch`` / ``mask_patch`` with
    their top-left corner at ``pos``."""
    side = patch.shape[0]
    y, x = pos
    canvas = patch.new_zeros((image_size, image_size, 3))
    canvas[y : y + side, x : x + side] = patch
    mask = patch.new_zeros((image_size, image_size, 3))
    mask[y : y + side, x : x + side] = mask_patch
    return canvas, mask


def square_transform(patch: torch.Tensor, image_size: int,
                     generator: Optional[torch.Generator] = None, *, draw=None):
    """Random quarter-turn rotation and placement -> ``(canvas, mask, (y,
    x))``: the full-image patch canvas, its binary mask and the placement,
    for exact re-cropping. ``draw = (k, (y, x))`` replaces the generator's
    draw."""
    side = patch.shape[0]
    if draw is None:
        k = int(torch.randint(0, 4, (), generator=generator, device=generator.device))
        pos = _draw_pos(generator, image_size, side)
    else:
        k, pos = int(draw[0]), _placement(draw[1], image_size, side)
    patch = torch.rot90(patch, k, dims=(0, 1))
    canvas, mask = _place(patch, 1.0, image_size, pos)
    return canvas, mask, pos


def circle_transform(patch: torch.Tensor, image_size: int,
                     generator: Optional[torch.Generator] = None, *, draw=None):
    """Rotation by an angle in [0, 2 pi) and random placement for circular
    patches -> ``(canvas, mask, (y, x))``. ``draw = (angle, (y, x))``
    replaces the generator's draw."""
    side = patch.shape[0]
    if draw is None:
        angle = torch.rand((), generator=generator, device=generator.device) * (2 * math.pi)
        pos = _draw_pos(generator, image_size, side)
    else:
        angle, pos = draw[0], _placement(draw[1], image_size, side)
    cmask = _circle_mask(side, patch.device).to(patch.dtype)
    canvas, mask = _place(_rotate_bilinear(patch, angle).to(patch.dtype) * cmask, cmask,
                          image_size, pos)
    return canvas, mask, pos


def extract_patch(canvas: torch.Tensor, pos, side: int) -> torch.Tensor:
    """Crop the patch back out of the canvas at its known placement (the
    reference's ``submatrix`` bounding-box search, `:216-236`, is not needed
    when the placement is known)."""
    y, x = pos
    return canvas[y : y + side, x : x + side].clone()


def submatrix(mask_2d: np.ndarray) -> np.ndarray:
    """Host-side bounding-box crop of a nonzero region, kept for API parity
    with the reference's external util (`adversarial_patch.py:19`)."""
    arr = np.asarray(mask_2d)
    nz = np.argwhere(arr != 0)
    if nz.size == 0:
        return arr[:0, :0]
    (y0, x0), (y1, x1) = nz.min(0), nz.max(0)
    return arr[y0 : y1 + 1, x0 : x1 + 1]


def apply_patch(inputs: torch.Tensor, patch_canvas: torch.Tensor, mask: torch.Tensor):
    """``patch_white_box`` composite (`attack_main2.py:413-433`): paste the
    trained patch on every image, each clamped to its own range."""
    lo = inputs.amin(dim=(1, 2, 3), keepdim=True)
    hi = inputs.amax(dim=(1, 2, 3), keepdim=True)
    return masked_composite(inputs, patch_canvas, mask, lo, hi)


# ---------------------------------------------------------------------------
# patch training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    """Defaults mirror the reference argparse (`attack_main2.py:866-876`)."""

    patch_type: str = "square"  # or "circle"
    patch_frac: float = 0.1
    max_count: int = 50
    epochs: int = 1
    # loss coefficients (`adversarial_patch.py:126`): only -l_latent_org active
    w_latent_target: float = 0.0
    w_latent_org: float = -1.0
    w_img_rec_target: float = 0.0
    w_lpips_rec_target: float = 0.0
    step_size: float = 1.0  # reference uses raw grad (`patch -= adv_grad`)
    # The JAX package's lax.scan unroll factor of the inner loop. A Python
    # loop has nothing to unroll: kept for name parity and ignored.
    unroll: int = 1


def _mse(a, b):
    d = a.float() - b.float()
    return (d * d).mean()


def make_patch_attack_step(pipeline: FusionPipeline, config: PatchConfig,
                           target_img: Optional[torch.Tensor] = None):
    """One batch of patch training. Returns ``step(img, patch, generator=None,
    *, draw=None) -> (patch', loss_trace)``: ``img`` is (1, S, S, 3), ``patch``
    the small HWC patch; the transform draws from ``generator`` unless
    ``draw`` is given. ``loss_trace`` holds the loss before each of the
    ``max_count`` inner steps."""
    cfg = config
    factor = pipeline.pool_factor
    size = pipeline.image_size
    transform = square_transform if cfg.patch_type == "square" else circle_transform
    need_rec = cfg.w_img_rec_target != 0.0 or cfg.w_lpips_rec_target != 0.0
    # the target terms enter only when a target exists and one of them is
    # weighted (the reference's default weights use none, `:126`)
    need_target = target_img is not None and (cfg.w_latent_target != 0.0 or need_rec)

    def loss_fn(canvas, img, mask, ref):
        adv = (1.0 - mask) * img + mask * canvas[None]
        adv_latent = pipeline.encoder(avg_pool(adv, factor))
        loss = cfg.w_latent_org * _mse(ref["latent_org"], adv_latent)
        if need_target:
            loss = loss + cfg.w_latent_target * _mse(ref["latent_target"], adv_latent)
            if need_rec:
                rec = pipeline.decode(adv_latent)
                loss = loss + cfg.w_img_rec_target * _mse(target_img, rec)
                if cfg.w_lpips_rec_target != 0.0:
                    feats_rec = pipeline.vgg(avg_pool(rec, factor))
                    loss = loss + cfg.w_lpips_rec_target * perceptual_distance(
                        feats_rec, ref["feats_target"])
        return loss

    def step(img, patch, generator=None, *, draw=None):
        canvas, mask, pos = transform(patch, size, generator, draw=draw)
        with torch.no_grad():
            ref = dict(latent_org=pipeline.encoder(avg_pool(img, factor)))
            if need_target:
                r_t = avg_pool(target_img, factor)
                ref.update(latent_target=pipeline.encoder(r_t), feats_target=pipeline.vgg(r_t))
        cmin, cmax = img.min(), img.max()
        trace = []
        for _ in range(cfg.max_count):
            c = canvas.detach().requires_grad_(True)
            loss = loss_fn(c, img, mask, ref)
            (g,) = torch.autograd.grad(loss, c)
            with torch.no_grad():
                canvas = canvas - cfg.step_size * mask * g
                canvas = torch.minimum(torch.maximum(canvas, cmin), cmax)
            trace.append(loss.detach())
        return extract_patch(canvas, pos, patch.shape[0]), torch.stack(trace)

    return step


def train_patch(pipeline: FusionPipeline, images: Iterable,
                generator: Optional[torch.Generator] = None,
                config: PatchConfig = PatchConfig(),
                target_img: Optional[torch.Tensor] = None, log_fn=None, *,
                init_patch: Optional[torch.Tensor] = None, draws: Optional[Iterable] = None):
    """Full patch training (`adversarial_patch.py:main` + ``train``): epochs
    x images of ``make_patch_attack_step``; returns the final full-canvas
    ``(canvas, mask)`` pair, ready for ``apply_patch``.

    ``images`` yields (1, S, S, 3) tensors (the reference trains with
    batch-size-1 loaders, `attack_main2.py:928`). The initial patch and each
    batch's transform draw from ``generator``, unless ``init_patch`` and
    ``draws`` (one transform draw per batch, in order) are given.
    ``log_fn(epoch, i, trace)`` receives each batch's loss trace as numpy."""
    cfg = config
    if init_patch is None:
        init = init_patch_square if cfg.patch_type == "square" else init_patch_circle
        init_patch = init(pipeline.image_size, cfg.patch_frac, generator)
    patch = init_patch
    step = make_patch_attack_step(pipeline, cfg, target_img)
    if cfg.epochs > 1:
        images = list(images)  # one-shot iterables must survive re-iteration
    draws = None if draws is None else iter(draws)

    for epoch in range(cfg.epochs):
        for i, img in enumerate(images):
            patch, trace = step(img, patch, generator,
                                draw=None if draws is None else next(draws))
            if log_fn is not None:
                log_fn(epoch, i, trace.float().cpu().numpy())

    return canonical_canvas(patch, pipeline.image_size, cfg.patch_type)


def canonical_canvas(patch: torch.Tensor, image_size: int, patch_type: str):
    """Final ``(canvas, mask)`` pair from a trained patch: centred, no
    rotation — the layout ``apply_patch`` consumes and ``patch.npz``
    persists (`adversarial_patch.py:238-239`)."""
    side = patch.shape[0]
    pos = ((image_size - side) // 2,) * 2
    if patch_type == "circle":
        m = _circle_mask(side, patch.device).to(patch.dtype)
    else:
        m = 1.0
    return _place(patch, m, image_size, pos)

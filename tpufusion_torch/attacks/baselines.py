"""Baseline perturbations (port of ``tpufusion/attacks/baselines.py``; the
reference's `attack_main2.py:273-462`).

- ``gaussian_blur_noise``: Gaussian-blur the inputs (`add_noise`, :273-282);
- ``dp_noise``: Laplace / differential-privacy noise (:284-297);
- ``paste_patch``: naive paste of a resized target image (:436-462);
- ``out_domain_more`` / ``out_domain_single``: replace all / one input(s)
  with the out-of-domain target (:376-404).

None of these reaches a TPU kernel in the JAX package; they stay plain
PyTorch here.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpufusion_torch.core.imaging import resize_bilinear


def _gaussian_taps(kernel_size: int, sigma: float, device) -> torch.Tensor:
    """The normalised 1-D Gaussian of ``kernel_size`` taps, in float32."""
    half = (kernel_size - 1) / 2.0
    x = torch.arange(kernel_size, dtype=torch.float32, device=device) - half
    k1 = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k1 / k1.sum()


def _band(k1: torch.Tensor, n: int) -> torch.Tensor:
    """(n, n) matrix of the 1-D convolution with ``k1`` over ``n`` samples
    with zero padding: row ``o`` holds tap ``i - o + pad`` at column ``i``."""
    pad = k1.shape[0] // 2
    idx = torch.arange(n, device=k1.device)
    off = idx[None, :] - idx[:, None] + pad
    inside = (off >= 0) & (off < k1.shape[0])
    return torch.where(inside, k1[off.clamp(0, k1.shape[0] - 1)], torch.zeros((), device=k1.device))


def gaussian_blur_noise(images: torch.Tensor, kernel_size: int, sigma: float = 0.0):
    """NHWC Gaussian blur with zero padding, computed in float32 and returned
    in ``images``' dtype. ``sigma <= 0`` derives it from the kernel size as
    cv2.GaussianBlur does (0.3*((k-1)*0.5 - 1) + 0.8). ``kernel_size`` must
    be odd, as cv2 requires.

    The JAX package convolves with the 2-D kernel ``outer(k1, k1)``; this is
    the same function as two 1-D passes, each one product with a banded
    matrix: at the runner's k = 409 on five 1024^2 images that is 2 x 1.6e10
    multiply-adds on the full band against 2.6e12 for the 2-D kernel."""
    if kernel_size % 2 == 0:
        raise ValueError(
            f"kernel_size must be odd (cv2.GaussianBlur semantics), got {kernel_size}")
    if sigma <= 0:
        sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    k1 = _gaussian_taps(kernel_size, sigma, images.device)
    _, h, w, _ = images.shape
    x = torch.einsum("oh,nhwc->nowc", _band(k1, h), images.float())
    x = torch.einsum("pw,nowc->nopc", _band(k1, w), x)
    return x.to(images.dtype)


def laplace_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Unit Laplace samples from uniform ``u`` in [-1 + epsneg, 1), as
    ``jax.random.laplace`` forms them: ``sign(u) * log1p(-|u|)``."""
    return torch.sign(u) * torch.log1p(-u.abs())


def dp_noise(images: torch.Tensor, generator: Optional[torch.Generator] = None,
             scale: float = 0.4, *, uniform: Optional[torch.Tensor] = None):
    """Additive Laplace noise of scale ``scale`` (`dp_noise`, :284-297;
    default scale from the ``--scale`` flag, `attack_main2.py:894`). The
    uniform draw comes from ``generator`` unless ``uniform`` (same shape as
    ``images``, in [-1 + epsneg, 1)) is given."""
    if uniform is None:
        lo = -1.0 + torch.finfo(torch.float32).eps / 2  # float32 epsneg
        uniform = torch.rand(images.shape, generator=generator, device=images.device)
        uniform = (uniform * (1.0 - lo) + lo).clamp_min(lo)
    noise = laplace_from_uniform(uniform.float()) * scale
    return (images.float() + noise).to(images.dtype)


def paste_patch(images: torch.Tensor, target_img: torch.Tensor, paste_times: int = 3):
    """`get_paste_image` (:449-462): resize the target to size // paste_times
    and paste it centred (at (size - paste) // 2, `attack_main2.py:313-314`)
    on every image."""
    size = images.shape[1]
    paste_size = size // paste_times
    loc = (size - paste_size) // 2
    small = resize_bilinear(target_img, paste_size, paste_size)
    out = images.clone()
    out[:, loc : loc + paste_size, loc : loc + paste_size] = small.to(images.dtype)
    return out


def out_domain_more(images: torch.Tensor, target_img: torch.Tensor):
    """Replace every input with the target (:376-381)."""
    return target_img.to(images.dtype).expand(images.shape).clone()


def out_domain_single(images: torch.Tensor, target_img: torch.Tensor, index: int):
    """Replace only the ``index``-th input (:390-395)."""
    out = images.clone()
    out[index] = target_img[0].to(images.dtype)
    return out

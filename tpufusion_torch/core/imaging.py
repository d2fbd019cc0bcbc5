"""Image math shared by every layer (port of ``tpufusion/core/imaging.py``).

Images are NHWC floats in [-1, 1]; the montage and uint8 helpers run on the
host in numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def clamp_pm1(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-1.0, 1.0)


def avg_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool NHWC by an integer factor: the exact mean of each
    ``factor x factor`` window (the reference's
    ``F.avg_pool2d(img, size/256, size/256)`` before every encoder call).
    ``factor == 1`` is the identity."""
    if factor == 1:
        return x
    n, h, w, c = x.shape
    if h % factor or w % factor:
        raise ValueError(f"avg_pool: {h}x{w} is not divisible by {factor}")
    return x.reshape(n, h // factor, factor, w // factor, factor, c).mean(dim=(2, 4))


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of NHWC images, as ``jax.image.resize(..., "bilinear")``
    computes it: antialiased when it shrinks (the triangle kernel widened by
    the scale), plain bilinear with half-pixel centres when it grows.
    Computed in float32, returned in ``x``'s dtype."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def to_uint8(x) -> np.ndarray:
    """[-1,1] float NHWC -> uint8, mirroring ``tensor2im``
    (`style_fusion_simple.py:16-22`): (x+1)/2, clip to [0,1], *255."""
    x = np.clip((_host(x) + 1.0) / 2.0, 0.0, 1.0) * 255.0
    return x.astype(np.uint8)


def from_uint8(x: np.ndarray) -> np.ndarray:
    """uint8 HWC/NHWC -> [-1,1] float32 (ToTensor + Normalize(.5,.5))."""
    return np.asarray(x, dtype=np.float32) / 255.0 * 2.0 - 1.0


def montage(images, padding: int = 2, pad_value: float = -1.0) -> np.ndarray:
    """Concatenate a batch of NHWC images into one horizontal strip on the
    host, with the geometry of the reference's ``vutils.save_image`` montages
    (5 FFHQ panels -> 5132x1028 with 2px padding): each tile gets a
    ``padding`` border; ``pad_value`` is in [-1, 1] space."""
    imgs = _host(images)
    if imgs.ndim == 3:
        imgs = imgs[None]
    n, h, w, c = imgs.shape
    out = np.full((h + 2 * padding, n * (w + padding) + padding, c), pad_value,
                  dtype=np.float32)
    for i in range(n):
        x0 = padding + i * (w + padding)
        out[padding : padding + h, x0 : x0 + w] = imgs[i]
    return out


def grid_montage(images, nrow: int = 8, padding: int = 2, pad_value: float = -1.0) -> np.ndarray:
    """vutils.save_image-style grid on the host: ``nrow`` images per row."""
    imgs = _host(images)
    if imgs.ndim == 3:
        imgs = imgs[None]
    n, h, w, c = imgs.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    out = np.full((nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
                  pad_value, dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = padding + r * (h + padding)
        x0 = padding + col * (w + padding)
        out[y0 : y0 + h, x0 : x0 + w] = imgs[i]
    return out

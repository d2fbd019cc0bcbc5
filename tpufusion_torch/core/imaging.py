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


def _interpolate(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                         antialias=True)


_RESIZE_WEIGHTS: dict = {}


def resize_weights(size_in: int, size_out: int, device) -> torch.Tensor:
    """(size_out, size_in) float32: row i holds the weights that the
    antialiased resize gives output i along one axis. Read off by resizing
    the identity on ``device`` (channel k holds row k, two columns wide,
    which the resize keeps as they are), so each entry is one weight times
    1: the weights that device's kernel uses, exactly. A width of one
    column would not do: PyTorch's CPU kernel resizes an (N, 1, H, 1)
    tensor wrongly. Cached per sizes and device (a graph's replays read
    the copy its warm-up made)."""
    key = (size_in, size_out, torch.device(device))
    w = _RESIZE_WEIGHTS.get(key)
    if w is None:
        eye = torch.eye(size_in, device=device)[None, :, :, None].expand(-1, -1, -1, 2)
        w = _interpolate(eye.contiguous(), size_out, 2)[0, :, :, 0].t().contiguous()
        _RESIZE_WEIGHTS[key] = w
    return w


class _Resize(torch.autograd.Function):
    """The antialiased resize with a deterministic backward. PyTorch's own
    (``upsample_bilinear2d_aa_backward``) accumulates with atomics on CUDA,
    so two runs of one attack part after a sign step flips; this one is the
    transposed map as two matrix products with ``resize_weights``."""

    @staticmethod
    def forward(ctx, x, height, width):
        ctx.in_size = x.shape[2:]
        return _interpolate(x, height, width)

    @staticmethod
    def backward(ctx, g):
        (h, w), (ho, wo) = ctx.in_size, g.shape[2:]
        wh = resize_weights(h, ho, g.device)
        ww = resize_weights(w, wo, g.device)
        return torch.matmul(wh.t(), torch.matmul(g, ww)), None, None


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of NHWC images, as ``jax.image.resize(..., "bilinear")``
    computes it: antialiased when it shrinks (the triangle kernel widened by
    the scale), plain bilinear with half-pixel centres when it grows.
    Computed in float32, returned in ``x``'s dtype. Its gradient is the
    same on every run (``_Resize``)."""
    y = _Resize.apply(x.float().permute(0, 3, 1, 2), height, width)
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

"""Image math shared by every layer (port of ``tpufusion/core/imaging.py``).

Images are NHWC floats in [-1, 1].
"""

from __future__ import annotations

import torch


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

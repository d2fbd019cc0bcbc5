"""upfirdn2d — upsample / FIR filter / downsample, the StyleGAN2 resampling op
(port of ``tpufusion/ops/upfirdn2d.py``).

All public tensors are NHWC. Padding/gain conventions follow rosinality:

- ``upsample_2x``:   pad = ((p+1)//2 + 1, p//2), p = len(k) - 2, gain 4.
- ``downsample_2x``: pad = ((p+1)//2, p//2),     p = len(k) - 2, gain 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _kernel_2d(taps: tuple, gain: float) -> np.ndarray:
    k = np.asarray(taps, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum() * gain


def make_blur_kernel(taps=(1, 3, 3, 1), gain: float = 1.0, device=None) -> torch.Tensor:
    """Normalised separable FIR kernel as a dense float32 2D tensor."""
    return torch.tensor(_kernel_2d(tuple(taps), float(gain)), device=device)


_DEVICE_KERNELS: dict = {}


def blur_kernel(taps, gain: float, device) -> torch.Tensor:
    """``make_blur_kernel`` on ``device``, built once per (taps, gain,
    device) and shared: callers only read it. A forward captured in a CUDA
    graph (``core/graphs.py``) then copies nothing from the host."""
    key = (tuple(taps), float(gain), torch.device(device))
    k = _DEVICE_KERNELS.get(key)
    if k is None:
        k = _DEVICE_KERNELS[key] = make_blur_kernel(taps, gain, device)
    return k


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: tuple = (0, 0)) -> torch.Tensor:
    """NHWC upsample-by-zero-stuffing, FIR filter (true convolution),
    downsample. Negative pads crop. The taps are cast to the activation
    dtype, as the JAX package does."""
    n, h, w, c = x.shape
    kh, kw = kernel.shape
    xn = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC memory
    if up > 1:
        xn = F.pad(xn.reshape(n, c, h, 1, w, 1), (0, up - 1, 0, 0, 0, up - 1))
        xn = xn.reshape(n, c, h * up, w * up)
    pad0, pad1 = pad
    xn = F.pad(xn, (pad0, pad1, pad0, pad1))
    filt = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    filt = filt[None, None].repeat(c, 1, 1, 1)
    y = F.conv2d(xn, filt, stride=down, groups=c)
    return y.permute(0, 2, 3, 1)


def blur(x: torch.Tensor, kernel: torch.Tensor, pad: tuple) -> torch.Tensor:
    """Plain FIR blur (rosinality ``Blur``; kernel pre-scaled by the caller)."""
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)


def upsample_2x(x: torch.Tensor, taps=(1, 3, 3, 1)) -> torch.Tensor:
    """2x zero-stuffed upsample + smoothing (rosinality ``Upsample``)."""
    k = blur_kernel(taps, 4.0, x.device)
    p = k.shape[0] - 2
    return upfirdn2d(x, k, up=2, down=1, pad=((p + 1) // 2 + 1, p // 2))


def downsample_2x(x: torch.Tensor, taps=(1, 3, 3, 1)) -> torch.Tensor:
    """Anti-aliased 2x downsample (rosinality ``Downsample``)."""
    k = blur_kernel(taps, 1.0, x.device)
    p = k.shape[0] - 2
    return upfirdn2d(x, k, up=1, down=2, pad=((p + 1) // 2, p // 2))

"""Modulated convolution — the StyleGAN2 workhorse (port of
``tpufusion/ops/modconv.py``).

The "input scaling" form of rosinality's ``ModulatedConv2d``:

    y[n] = conv(x[n] * s[n], W) * sigma[n]                      (demodulation)
    sigma[n, j] = rsqrt( sum_{i,kh,kw} (W[kh,kw,i,j] * s[n,i])^2 + 1e-8 )

so the batch shares one weight and modulation/demodulation are elementwise
scalings. The up path is a transposed conv followed by the rosinality blur;
the down path blurs then runs a stride-2 conv. sigma is computed in float32.

A 3x3 non-up non-down conv with Cin = Cout in {32, 64} goes through
``ops/conv3x3.py`` (the hand-written kernel on CUDA); every other conv is
``F.conv2d`` / ``F.conv_transpose2d``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpufusion_torch.ops.conv3x3 import conv3x3, supported as conv3x3_supported
from tpufusion_torch.ops.upfirdn2d import blur, blur_kernel


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def modulated_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    style: torch.Tensor,
    *,
    demodulate: bool = True,
    up: bool = False,
    down: bool = False,
    blur_taps=(1, 3, 3, 1),
) -> torch.Tensor:
    """Apply a style-modulated conv.

    Args:
      x:      (N, H, W, Cin) activations.
      weight: (kh, kw, Cin, Cout) unscaled weight; the equalized-lr scale
              ``1/sqrt(Cin*kh*kw)`` is applied here.
      style:  (N, Cin) post-affine style vector ``s``.
    """
    kh, kw, cin, cout = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    w = (weight * scale).to(x.dtype)
    s = style.to(x.dtype)
    xs = x * s[:, None, None, :]

    if up:
        # transposed conv == correlation of the 2x zero-dilated input with the
        # flipped kernel under full (k-1) padding; (Cin, Cout, kh, kw) layout
        y = _nhwc(F.conv_transpose2d(_nchw(xs), w.permute(2, 3, 0, 1), stride=2))
        k = blur_kernel(blur_taps, 4.0, x.device)
        p = (len(blur_taps) - 2) - (kh - 1)
        y = blur(y, k, pad=((p + 1) // 2 + 1, p // 2 + 1))
    elif down:
        k = blur_kernel(blur_taps, 1.0, x.device)
        p = (len(blur_taps) - 2) + (kh - 1)
        xs = blur(xs, k, pad=((p + 1) // 2, p // 2))
        y = _nhwc(F.conv2d(_nchw(xs), w.permute(3, 2, 0, 1), stride=2))
    elif conv3x3_supported(xs.shape, w.shape):
        y = conv3x3(xs.contiguous(), w.contiguous())
    else:
        y = _nhwc(F.conv2d(_nchw(xs), w.permute(3, 2, 0, 1), padding=(kh // 2, kw // 2)))

    if demodulate:
        w2 = ((weight.float() * scale) ** 2).sum(dim=(0, 1))  # (Cin, Cout)
        sigma = torch.rsqrt(style.float() ** 2 @ w2 + 1e-8)  # (N, Cout)
        y = y * sigma[:, None, None, :].to(y.dtype)
    return y

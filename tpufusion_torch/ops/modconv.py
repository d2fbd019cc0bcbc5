"""Modulated convolution — the StyleGAN2 workhorse (port of
``tpufusion/ops/modconv.py``).

The "input scaling" form of rosinality's ``ModulatedConv2d``:

    y[n] = conv(x[n] * s[n], W) * sigma[n]                      (demodulation)
    sigma[n, j] = rsqrt( sum_{i,kh,kw} (W[kh,kw,i,j] * s[n,i])^2 + 1e-8 )

so the batch shares one weight and modulation/demodulation are elementwise
scalings. The up path is rosinality's stride-2 transposed conv followed by
its blur. On bf16 inputs it runs folded (``fold_up_weight``,
``modulated_conv2d_up_folded``): the weights are frozen, so the two are one
stride-2 transposed conv whose kernel is the 3x3 convolved with the blur
taps (6x6), and each of its four output phases sees the input offsets
{-1, 0, +1} only. So the up conv is one "same" 3x3 conv from Cin to 4 Cout
channels at the input plane, then depth-to-space; no blur runs. Float32 and
float64 inputs run the unfolded chain, ``modulated_conv2d_up_plain``, also
the twin the fold is held against. The down path blurs then runs a stride-2
conv. sigma is computed in float32, on the unfolded weight (demodulation
commutes with the per-channel blur).

A 3x3 non-up non-down conv with Cin = Cout in {32, 64} goes through
``ops/conv3x3.py`` (the hand-written kernel on CUDA); every other conv is
``F.conv2d`` / ``F.conv_transpose2d``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from tpufusion_torch.ops.conv3x3 import conv3x3, supported as conv3x3_supported
from tpufusion_torch.ops.upfirdn2d import _kernel_2d, blur, blur_kernel


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _up_fold_plan(k: int, taps: tuple):
    """The fold of a stride-2 k x k transposed conv and rosinality's up blur
    (``taps``, gain 4, pad ((p+1)//2 + 1, p//2 + 1), p = len(taps) - 2 -
    (k - 1)) into four phase convs: ``(M, P, (lo, hi))`` with M (P*P*4, k*k)
    the phase taps' coefficients of the k x k taps, P the phase kernels'
    size and (lo, hi) their "same" padding ((1, 1) for k = 3 and 4 taps, P =
    3).

    In 1-D, with the blur a true convolution: y[q] = sum_i x[i] E[q - 2i +
    D], E = w * f (length k + L - 1), D = L - 1 - pad0. Output phase a of
    q = 2r + a reads x[r + u] with tap E[a + D - 2u], for the u where that
    index lies in E. Row (jy, jx, a, b) of M holds, at (ty, tx), the blur
    tap that weights w[ty, tx] in E at the phase (a, b) tap (jy, jx)."""
    f = _kernel_2d(taps, 4.0).astype(np.float64)
    big = f.shape[0]
    p = (big - 2) - (k - 1)
    d = big - 1 - ((p + 1) // 2 + 1)
    last = k + big - 2  # E's last index
    umin = min(-((last - a - d) // 2) for a in (0, 1))
    umax = max((a + d) // 2 for a in (0, 1))
    size = umax - umin + 1
    m = np.zeros((size, size, 2, 2, k, k))
    for jy in range(size):
        for jx in range(size):
            for a in (0, 1):
                for b in (0, 1):
                    ey, ex = a + d - 2 * (jy + umin), b + d - 2 * (jx + umin)
                    for ty in range(k):
                        for tx in range(k):
                            if 0 <= ey - ty < big and 0 <= ex - tx < big:
                                m[jy, jx, a, b, ty, tx] = f[ey - ty, ex - tx]
    return m.reshape(size * size * 4, k * k), size, (-umin, umax)


_FOLD_MATRICES: dict = {}


def fold_up_weight(w: torch.Tensor, blur_taps=(1, 3, 3, 1)):
    """The up conv's folded weights: ``(w4, (lo, hi))`` with w4 (P, P, Cin,
    4 Cout) HWIO, the output channels phase-major (channel ``(2 a + b) Cout
    + co`` is output pixel (2 i + a, 2 j + b) of channel co), in ``w``'s
    float dtype: the folded composite rounds it to the compute dtype once.
    ``w`` (k, k, Cin, Cout) holds the scaled (equalised-lr) weights. One
    (P*P*4, k*k) x (k*k, Cin*Cout) product; its matrix is built once per
    (k, taps, device) and shared, so a CUDA graph copies nothing from the
    host (only a plain tensor is kept: one made while ``torch.export``
    traces is a fake)."""
    k, _, cin, cout = w.shape
    key = (k, tuple(blur_taps), w.device)
    m = _FOLD_MATRICES.get(key)
    if m is None:
        plan, size, pad = _up_fold_plan(k, tuple(blur_taps))
        m = (torch.tensor(plan, dtype=torch.float32, device=w.device), size, pad)
        if type(m[0]) is torch.Tensor:
            _FOLD_MATRICES[key] = m
    mat, size, pad = m
    w4 = (mat.to(w.dtype) @ w.reshape(k * k, cin * cout)).view(size, size, 4, cin, cout)
    return w4.permute(0, 1, 3, 2, 4).reshape(size, size, cin, 4 * cout), pad


def depth_to_space(y4: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 4 C) phase-major -> (N, 2H, 2W, C): channel (2 a + b) C + c
    of pixel (i, j) goes to pixel (2 i + a, 2 j + b)."""
    n, h, w, c4 = y4.shape
    c = c4 // 4
    return y4.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, c)


def space_to_depth(y: torch.Tensor) -> torch.Tensor:
    """(N, 2H, 2W, C) -> (N, H, W, 4 C) phase-major: ``depth_to_space``'s
    inverse."""
    n, h2, w2, c = y.shape
    h, w = h2 // 2, w2 // 2
    return y.reshape(n, h, 2, w, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, 4 * c)


def up_conv_folded(xs: torch.Tensor, w: torch.Tensor, blur_taps=(1, 3, 3, 1)) -> torch.Tensor:
    """The up conv of the modulated input ``xs`` (N, H, W, Cin) by the
    scaled float32 weights ``w`` (k, k, Cin, Cout), folded: one "same" conv
    to 4 Cout phase channels at the input plane, then depth-to-space."""
    w4, (lo, hi) = fold_up_weight(w, blur_taps)
    xn, wn = _nchw(xs), w4.to(xs.dtype).permute(3, 2, 0, 1)
    if lo != hi:
        xn, lo = F.pad(xn, (lo, hi, lo, hi)), 0
    return depth_to_space(_nhwc(F.conv2d(xn, wn, padding=lo)))


def _demodulated(y, weight, style, scale):
    w2 = ((weight.float() * scale) ** 2).sum(dim=(0, 1))  # (Cin, Cout)
    sigma = torch.rsqrt(style.float() ** 2 @ w2 + 1e-8)  # (N, Cout)
    return y * sigma[:, None, None, :].to(y.dtype)


def modulated_conv2d_up_folded(x, weight, style, *, demodulate=True, blur_taps=(1, 3, 3, 1)):
    """The up conv folded (``up_conv_folded``: the weights folded in float32,
    rounded to x's dtype once), then demodulation."""
    kh, kw, cin, cout = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    xs = x * style.to(x.dtype)[:, None, None, :]
    y = up_conv_folded(xs, weight.float() * scale, blur_taps)
    return _demodulated(y, weight, style, scale) if demodulate else y


def modulated_conv2d_up_plain(x, weight, style, *, demodulate=True, blur_taps=(1, 3, 3, 1)):
    """The up conv as rosinality runs it: the transposed conv on the rounded
    weights, then the blur, then demodulation. The twin the fold is held
    against, and the up path of float32 and float64 inputs."""
    kh, kw, cin, cout = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    w = (weight * scale).to(x.dtype)
    xs = x * style.to(x.dtype)[:, None, None, :]
    # transposed conv == correlation of the 2x zero-dilated input with the
    # flipped kernel under full (k-1) padding; (Cin, Cout, kh, kw) layout
    y = _nhwc(F.conv_transpose2d(_nchw(xs), w.permute(2, 3, 0, 1), stride=2))
    k = blur_kernel(blur_taps, 4.0, x.device)
    p = (len(blur_taps) - 2) - (kh - 1)
    y = blur(y, k, pad=((p + 1) // 2 + 1, p // 2 + 1))
    return _demodulated(y, weight, style, scale) if demodulate else y


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
    if up:
        # folded where the inputs are rounded to 16 bits. In float32 the
        # unfolded chain keeps its numbers: the blur's taps cancel a
        # gradient's checkerboard part exactly, where folded into the weights
        # that part cancels inside the conv's sums, and float32 sums lost 3-4
        # digits of a 32^2 synthesis's up-conv input gradient
        up_conv = (modulated_conv2d_up_folded if x.element_size() < 4
                   else modulated_conv2d_up_plain)
        return up_conv(x, weight, style, demodulate=demodulate, blur_taps=blur_taps)
    kh, kw, cin, cout = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    s = style.to(x.dtype)
    xs = x * s[:, None, None, :]
    w = (weight * scale).to(x.dtype)

    if down:
        k = blur_kernel(blur_taps, 1.0, x.device)
        p = (len(blur_taps) - 2) + (kh - 1)
        xs = blur(xs, k, pad=((p + 1) // 2, p // 2))
        y = _nhwc(F.conv2d(_nchw(xs), w.permute(3, 2, 0, 1), stride=2))
    elif conv3x3_supported(xs.shape, w.shape):
        y = conv3x3(xs.contiguous(), w.contiguous())
    else:
        y = _nhwc(F.conv2d(_nchw(xs), w.permute(3, 2, 0, 1), padding=(kh // 2, kw // 2)))

    return _demodulated(y, weight, style, scale) if demodulate else y

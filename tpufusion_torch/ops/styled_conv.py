"""Fused StyledConv — modulate + 3x3 conv + demodulate + noise + bias +
leaky-ReLU(sqrt 2) in one pass (port of ``tpufusion/ops/styled_conv.py``).

Kernel: ``csrc/styled_conv.cu``, replacing the TPU kernel
``tpufusion/ops/styled_conv.py::_pallas_styled_conv`` (``_kernel``). The
kernel reads x once and writes y once: modulation happens as the input tile
loads, demodulation, bias, noise and the activation before the store. Its
bounds on an H100 are in the source note; at C >= 128 it is
operations-bound, at C = 32 / 1024^2 memory-bound.

The forward is the kernel; the backward is autograd of the composite
``styled_conv_reference``, recomputed, as ``_fsc_bwd`` does in JAX. Inside
that recompute the 32/64-channel convs go through ``ops/conv3x3.py``.

The TPU dispatcher's even-H/W and H >= 16 limits were artefacts of its row
tiling; this kernel takes every 3x3 styled conv with Cin % 16 == 0,
Cout % 32 == 0 and one shared ``(1, H, W, 1)`` noise plane, 4^2 and 8^2
included. Per-sample noise stays on the composite, as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpufusion_torch.ops import _lib
from tpufusion_torch.ops.modconv import modulated_conv2d

SQRT2 = math.sqrt(2.0)


def noise_bias_act(y, noise, noise_strength, bias):
    """The styled-conv epilogue: noise injection + bias + leaky-ReLU * sqrt2
    (rosinality ``NoiseInjection`` then ``FusedLeakyReLU``)."""
    y = y + noise_strength.to(y.dtype) * noise.to(y.dtype)
    return F.leaky_relu(y + bias.to(y.dtype), 0.2) * SQRT2


def styled_conv_reference(x, weight, style, noise, noise_strength, bias):
    """The composite: ``modulated_conv2d`` + ``noise_bias_act`` (also the
    backward's recompute)."""
    y = modulated_conv2d(x, weight, style, demodulate=True, up=False)
    return noise_bias_act(y, noise, noise_strength, bias)


def styled_conv_plain(x, weight, style, noise, noise_strength, bias):
    """The kernel's function in plain PyTorch only (``F.conv2d``, no kernel
    on any device): the twin the kernel is held against."""
    cin = x.shape[-1]
    scale = 1.0 / math.sqrt(9 * cin)
    xs = x * style.to(x.dtype)[:, None, None, :]
    w = (weight * scale).to(x.dtype)
    y = F.conv2d(xs.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    w2 = ((weight.float() * scale) ** 2).sum(dim=(0, 1))
    sigma = torch.rsqrt(style.float() ** 2 @ w2 + 1e-8)
    return noise_bias_act(y * sigma[:, None, None, :].to(y.dtype), noise,
                          noise_strength, bias)


def supported(x_shape, w_shape, noise_shape) -> bool:
    """Shapes the kernel takes: 3x3, Cin % 16 == 0, Cout % 32 == 0 and one
    shared (1, H, W, 1) noise plane."""
    kh, kw, cin, cout = w_shape
    n, h, w, c = x_shape
    return ((kh, kw) == (3, 3) and cin == c and cin % 16 == 0 and cout % 32 == 0
            and tuple(noise_shape) == (1, h, w, 1))


def styled_conv_kernel(x, weight, style, noise, noise_strength, bias):
    """Launch the fused kernel. The wrapper scales the weights and computes
    sigma (float32) and the pre-scaled noise plane, as
    ``_pallas_styled_conv`` does around its kernel."""
    fn = _lib.load("styled_conv").tf_styled_conv_fwd
    if not x.is_cuda or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("styled_conv: x must be a contiguous (N,H,W,C) CUDA tensor")
    if not supported(x.shape, weight.shape, noise.shape):
        raise ValueError(f"styled_conv: unsupported shapes x {tuple(x.shape)}, "
                         f"w {tuple(weight.shape)}, noise {tuple(noise.shape)}")
    n, h, w, cin = x.shape
    cout = weight.shape[3]
    if (tuple(style.shape) != (n, cin) or tuple(bias.shape) != (cout,)
            or noise_strength.numel() != 1):
        raise ValueError(f"styled_conv: style {tuple(style.shape)} / bias "
                         f"{tuple(bias.shape)} / noise_strength "
                         f"{tuple(noise_strength.shape)} do not match x and w")
    for name, t in (("weight", weight), ("style", style), ("noise", noise),
                    ("noise_strength", noise_strength), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"styled_conv: {name} is on {t.device}, x on {x.device}")
    code = _lib.dtype_code(x)
    scale = 1.0 / math.sqrt(9 * cin)
    w_s = (weight * scale).to(x.dtype).contiguous()
    w2 = ((weight.float() * scale) ** 2).sum(dim=(0, 1))
    s32 = style.float()
    sigma = torch.rsqrt(s32 ** 2 @ w2 + 1e-8).contiguous()
    s_in = style.to(x.dtype).float().contiguous()
    noise2d = (noise_strength.float() * noise.reshape(h, w).float()).contiguous()
    b = bias.float().contiguous()
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    rc = fn(*[t.data_ptr() for t in (x, w_s, y, s_in, sigma, b, noise2d)],
            n, h, w, cin, cout, code, _lib.stream_ptr(x))
    _lib.check(rc, "styled_conv")
    return y


class _StyledConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, style, noise, noise_strength, bias):
        ctx.save_for_backward(x, weight, style, noise, noise_strength, bias)
        y = styled_conv_kernel(x, weight, style, noise, noise_strength, bias)
        styled_conv.launches += 1
        return y

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(nd)
                      for t, nd in zip(ctx.saved_tensors, need)]
            y = styled_conv_reference(*inputs)
            wrt = [t for t, nd in zip(inputs, need) if nd]
            grads = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        return tuple(next(grads) if nd else None for nd in need)


def styled_conv(x, weight, style, noise, noise_strength, bias):
    """Non-upsampling styled conv. CPU tensors, and shapes the kernel does not
    take, run the composite; CUDA tensors of the kernel's shapes launch it
    (or raise)."""
    if x.device.type == "cpu" or not supported(x.shape, weight.shape, noise.shape):
        return styled_conv_reference(x, weight, style, noise, noise_strength, bias)
    return _StyledConv.apply(x.contiguous(), weight, style, noise, noise_strength, bias)


styled_conv.launches = 0

"""e4e (encoder4editing) image -> W+ encoder (port of
``tpufusion/models/e4e.py``).

IR-SE backbone with three feature taps feeding progressive "gradual style"
heads; head 0 predicts w_0, heads 1.. predict deltas added on top. Parameters
and buffers carry the e4e checkpoint's ``encoder.`` names (prefix stripped):
``input_layer.{0,1,2}``, ``body.{i}.res_layer.{0..5}``,
``body.{i}.shortcut_layer.{0,1}``, ``styles.{h}.convs.{2k}``,
``styles.{h}.linear``, ``latlayer{1,2}``. ``c3_proj`` exists only in the tiny
test encoders whose last stage is not 512 wide. Activations are NHWC.

The JAX package groups units with ``nn.scan`` and heads with ``nn.vmap`` to
bound TPU compile time; here they are plain ``nn.ModuleList``s.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.models.stylegan2 import EqualLinear


class Conv2d(nn.Module):
    """``nn.Conv2d`` parameters (OIHW ``weight``, optional ``bias``) on NHWC
    activations; weights drawn LeCun-normal from ``generator``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, *, device=None,
                 generator=None):
        super().__init__()
        std = 1.0 / math.sqrt(cin * k * k)
        self.weight = nn.Parameter(
            torch.randn((cout, cin, k, k), generator=generator, device=device) * std)
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class Linear(nn.Module):
    """``nn.Linear`` parameters (``weight`` (out, in), ``bias``), computed in
    the input's dtype; the weight drawn LeCun-normal from ``generator``, the
    bias zero."""

    def __init__(self, fan_in, fan_out, *, device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn((fan_out, fan_in), generator=generator, device=device)
            / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(fan_out, device=device))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm: y = scale*(x-mean)/sqrt(var+eps) + bias, with
    ``nn.BatchNorm2d``'s state-dict names."""

    def __init__(self, channels, eps=1e-5, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))
        self.eps = eps

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        return x * inv.to(x.dtype) + (self.bias - self.running_mean * inv).to(x.dtype)


class PReLU(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25, device=device))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class SEModule(nn.Module):
    def __init__(self, channels, reduction=16, *, device=None, generator=None):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.fc1 = Conv2d(channels, mid, 1, bias=False, device=device, generator=generator)
        self.fc2 = Conv2d(mid, channels, 1, bias=False, device=device, generator=generator)

    def forward(self, x):
        s = x.float().mean(dim=(1, 2)).to(x.dtype)  # (N, C) global pool
        s = torch.relu(s @ self.fc1.weight.flatten(1).to(x.dtype).t())
        s = torch.sigmoid(s @ self.fc2.weight.flatten(1).to(x.dtype).t())
        return x * s[:, None, None, :]


class BottleneckIRSE(nn.Module):
    def __init__(self, cin, depth, stride, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        if cin != depth:
            self.shortcut_layer = nn.Sequential(
                Conv2d(cin, depth, 1, stride, bias=False, **kw), FrozenBatchNorm(depth, device=device))
        else:
            self.shortcut_layer = None  # MaxPool2d(1, stride): a strided subsample
        self.res_layer = nn.Sequential(
            FrozenBatchNorm(cin, device=device),
            Conv2d(cin, depth, 3, 1, 1, bias=False, **kw),
            PReLU(depth, device=device),
            Conv2d(depth, depth, 3, stride, 1, bias=False, **kw),
            FrozenBatchNorm(depth, device=device),
            SEModule(depth, 16, **kw),
        )
        self.stride = stride

    def forward(self, x):
        if self.shortcut_layer is None:
            shortcut = x if self.stride == 1 else x[:, ::self.stride, ::self.stride, :]
        else:
            shortcut = self.shortcut_layer(x)
        return self.res_layer(x) + shortcut


class GradualStyleBlock(nn.Module):
    """spatial^2 feature map -> one style via strided 3x3 convs + linear."""

    def __init__(self, cin, cout, spatial, *, policy: Policy, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mods = []
        for i in range(int(math.log2(spatial))):
            mods += [Conv2d(cin if i == 0 else cout, cout, 3, 2, 1, **kw), nn.LeakyReLU(0.01)]
        self.convs = nn.Sequential(*mods)
        self.linear = EqualLinear(cout, cout, policy=policy, **kw)

    def forward(self, x):
        x = self.convs(x)
        return self.linear(x.reshape(x.shape[0], -1))


def _upsample_add(x, y):
    """Bilinear (align_corners=True) upsample of NHWC x to y's size, + y."""
    h, w = y.shape[1], y.shape[2]
    if (x.shape[1], x.shape[2]) == (h, w):
        return x + y
    up = F.interpolate(x.float().permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                       align_corners=True)
    return up.permute(0, 2, 3, 1).to(y.dtype) + y


class Encoder4Editing(nn.Module):
    """IR-SE backbone + progressive style heads; returns (N, n_styles, 512)
    float32 raw codes (``latent_avg`` is added by ``pipeline.latents_with``).
    Built on ``device``, ``cuda`` unless given."""

    def __init__(self, n_styles: int = 18, style_dim: int = 512, base_channels: int = 64,
                 unit_counts: Sequence[int] = (3, 4, 14, 3), input_size: int = 256,
                 coarse_ind: int = 3, middle_ind: int = 7, *,
                 policy: Optional[Policy] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.policy = policy or default_policy(device)
        kw = dict(device=device, generator=generator)
        b = base_channels
        depths = (b, 2 * b, 4 * b, 8 * b)
        self.n_styles = n_styles
        self.style_dim = style_dim
        self.base_channels = base_channels
        self.unit_counts = tuple(unit_counts)
        self.coarse_ind, self.middle_ind = coarse_ind, middle_ind

        self.input_layer = nn.Sequential(
            Conv2d(3, b, 3, 1, 1, bias=False, **kw), FrozenBatchNorm(b, device=device),
            PReLU(b, device=device))
        units, cin = [], b
        for depth, n_units in zip(depths, self.unit_counts):
            units.append(BottleneckIRSE(cin, depth, 2, **kw))
            units += [BottleneckIRSE(depth, depth, 1, **kw) for _ in range(n_units - 1)]
            cin = depth
        self.body = nn.ModuleList(units)
        ends = [sum(self.unit_counts[:s + 1]) - 1 for s in range(4)]
        self.tap_indices = tuple(ends[1:])  # c1, c2, c3

        s_c3 = input_size // 16
        self.styles = nn.ModuleList()
        for h in range(n_styles):
            if h < coarse_ind:
                self.styles.append(GradualStyleBlock(depths[3], style_dim, s_c3,
                                                     policy=self.policy, **kw))
            elif h < middle_ind:
                self.styles.append(GradualStyleBlock(style_dim, style_dim, 2 * s_c3,
                                                     policy=self.policy, **kw))
            else:
                self.styles.append(GradualStyleBlock(style_dim, style_dim, 4 * s_c3,
                                                     policy=self.policy, **kw))
        self.latlayer1 = Conv2d(depths[2], style_dim, 1, **kw)
        self.latlayer2 = Conv2d(depths[1], style_dim, 1, **kw)
        if depths[3] != style_dim:
            self.c3_proj = Conv2d(depths[3], style_dim, 1, **kw)

    def forward(self, x):
        y = self.input_layer(x.to(self.policy.compute_dtype))
        taps = []
        for i, unit in enumerate(self.body):
            y = unit(y)
            if i in self.tap_indices:
                taps.append(y)
        c1, c2, c3 = taps
        p2 = _upsample_add(self.c3_proj(c3) if hasattr(self, "c3_proj") else c3,
                           self.latlayer1(c2))
        p1 = _upsample_add(p2, self.latlayer2(c1))
        outs = []
        for h, head in enumerate(self.styles):
            feat = c3 if h < self.coarse_ind else (p2 if h < self.middle_ind else p1)
            outs.append(head(feat))
        w = torch.stack(outs, dim=1).float()
        # progressive: w_i = w_0 + delta_i (inference: all stages active)
        return torch.cat([w[:, :1], w[:, 1:] + w[:, :1]], dim=1)

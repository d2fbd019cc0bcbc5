"""StyleGAN2 discriminator (port of ``tpufusion/models/discriminator.py``).

The reference loads a stylegan2-ada ``D`` from ``ffhq.pkl``
(`attack_main2.py:934-938`) and, in commented-out scoring blocks
(`:1029-1032,1091-1094`), prints realism scores of benign and adversarial
fused images. The math is the JAX package's (rosinality's residual
discriminator): a 1x1 conv stem, residual blocks that halve the resolution
(blurred 3x3 and 1x1-skip down convs), minibatch stddev, a final conv and
two linears -> (N, 1) logits.

Parameters carry the ada ``D`` tensor paths, so the tensors of an ada pickle
load by name (``load_ada_discriminator``): ``b{size}.fromrgb``,
``b{res}.conv0`` / ``conv1`` (the down conv) / ``skip``, ``b4.conv``,
``b4.fc``, ``b4.out``; conv weights OIHW. Activations are NHWC; ``b4.fc``
reads the final features flattened in NCHW order, as ada's does. The convs
are ``F.conv2d``: the JAX package leaves them to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.io.checkpoint import load_named_state
from tpufusion_torch.models.stylegan2 import EqualLinear, channel_map
from tpufusion_torch.ops.upfirdn2d import blur, make_blur_kernel

SQRT2 = math.sqrt(2.0)


class EqualConv(nn.Module):
    """Conv with equalized lr (scale 1/sqrt(fan_in)), optional bias and
    leaky-ReLU (gain sqrt 2); ``down`` blurs, then convolves with stride 2."""

    def __init__(self, cin, cout, kernel=3, *, down=False, bias=True, activate=True,
                 device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn((cout, cin, kernel, kernel), generator=generator, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None
        self.scale = 1.0 / math.sqrt(cin * kernel * kernel)
        self.kernel = kernel
        self.down = down
        self.activate = activate

    def forward(self, x):
        k = self.kernel
        w = (self.weight * self.scale).to(x.dtype)
        if self.down:
            p = 2 + (k - 1)
            x = blur(x, make_blur_kernel((1, 3, 3, 1), 1.0, device=x.device),
                     pad=((p + 1) // 2, p // 2))
            y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=2)
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=k // 2)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.activate:
            y = F.leaky_relu(y, 0.2) * SQRT2
        return y


class ResBlock(nn.Module):
    """``conv0`` (3x3) and the down ``conv1`` beside the down 1x1 ``skip``;
    the first block also holds the ``fromrgb`` stem."""

    def __init__(self, cin, cout, *, from_rgb=False, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        if from_rgb:
            self.fromrgb = EqualConv(3, cin, 1, **kw)
        self.conv0 = EqualConv(cin, cin, 3, **kw)
        self.conv1 = EqualConv(cin, cout, 3, down=True, **kw)
        self.skip = EqualConv(cin, cout, 1, down=True, bias=False, activate=False, **kw)

    def forward(self, x):
        if hasattr(self, "fromrgb"):
            x = self.fromrgb(x)
        return (self.conv1(self.conv0(x)) + self.skip(x)) / SQRT2


class Epilogue(nn.Module):
    """Minibatch stddev, the final conv and the two linears (ada's ``b4``)."""

    def __init__(self, channels, stddev_group, *, policy, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.stddev_group = stddev_group
        self.conv = EqualConv(channels + 1, channels, 3, **kw)
        self.fc = EqualLinear(channels * 16, channels, activate=True, policy=policy, **kw)
        self.out = EqualLinear(channels, 1, policy=policy, **kw)

    def forward(self, x):
        # the group is the largest divisor of the batch not above
        # stddev_group, so any batch gets a cross-sample statistic
        n, h, w, c = x.shape
        g = min(self.stddev_group, n)
        while n % g:
            g -= 1
        y = x.reshape(g, n // g, h, w, c).float()
        std = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8).mean(dim=(1, 2, 3))
        std = std.reshape(n // g, 1, 1, 1).repeat(g, h, w, 1)
        x = torch.cat([x, std.to(x.dtype)], dim=-1)
        x = self.conv(x)
        x = x.permute(0, 3, 1, 2).reshape(n, -1)  # ada's NCHW flatten
        return self.out(self.fc(x))


class Discriminator(nn.Module):
    """``forward(images_nhwc_pm1) -> (N, 1)`` realism logits, on ``device``
    (``cuda`` unless given), weights drawn from ``generator``."""

    def __init__(self, size: int = 1024, channel_multiplier: int = 2, stddev_group: int = 4,
                 *, policy: Optional[Policy] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.policy = policy or default_policy(device)
        self.size = size
        kw = dict(device=device, generator=generator)
        ch = channel_map(size, channel_multiplier)
        self.resolutions = []
        res = size
        while res > 4:
            self.add_module(f"b{res}", ResBlock(ch[res], ch[res // 2], from_rgb=res == size,
                                                **kw))
            self.resolutions.append(res)
            res //= 2
        self.b4 = Epilogue(ch[4], stddev_group, policy=self.policy, **kw)

    def forward(self, images):
        x = images.to(self.policy.compute_dtype)
        for res in self.resolutions:
            x = getattr(self, f"b{res}")(x)
        return self.b4(x)


def create_discriminator(size: int, *, channel_multiplier: int = 2,
                         policy: Optional[Policy] = None, device=None,
                         seed: int = 0) -> Discriminator:
    """A discriminator with seeded random weights, frozen, on ``device``
    (``cuda`` unless given)."""
    device = resolve_device(device)
    d = Discriminator(size, channel_multiplier, policy=policy, device=device,
                      generator=torch.Generator(device=device).manual_seed(seed))
    return d.requires_grad_(False)


def realism_scores(d: Discriminator, images) -> torch.Tensor:
    """Per-image D logits for the benign / adversarial comparison
    (`attack_main2.py:1029-1032`)."""
    return d(images)[:, 0]


def load_ada_discriminator(tensors: Mapping, d: Discriminator) -> Discriminator:
    """The ``{dotted_path: array}`` tensors of an ada ``D`` (``io.ada_pkl.
    load_network_pkl_tensors(path)['D']``) -> ``d``, by name: both sides scale
    the weights by 1/sqrt(fan_in) at run time and flatten ``b4.fc``'s input
    in NCHW order, so no tensor is transposed. Biases are reshaped to
    (out,); the other ada entries (resample filters) are not read; a
    missing one raises ``KeyError``."""
    return load_named_state(d, tensors)

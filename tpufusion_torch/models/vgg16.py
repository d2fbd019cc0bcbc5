"""VGG16 perceptual taps (port of ``tpufusion/models/vgg16.py``; the
reference's ``code/vgg.py``).

The forward runs through conv4_2 and returns the four taps of the perceptual
loss:

    (relu(conv1_1), relu(conv1_2), pool2 output, relu(conv4_2))

The third tap is the pool2 output, which the reference misnames ``conv3_2``.
Input is NHWC in [-1, 1] with no ImageNet normalisation, as the reference
feeds it. pool3 is a ceil-mode max pool (the JAX package pads with -inf on
the right and bottom). Parameters carry the reference's names
(``conv1_1.weight`` OIHW, ``conv1_1.bias`` ... ``conv4_2``), so the published
``imagenet_vgg16.pth`` loads positionally. The convs stay ``F.conv2d``: the
JAX package leaves them to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.models.e4e import Conv2d

# (name, in_channels, out_channels) of the layers the forward uses
LAYERS = (
    ("conv1_1", 3, 64),
    ("conv1_2", 64, 64),
    ("conv2_1", 64, 128),
    ("conv2_2", 128, 128),
    ("conv3_1", 128, 256),
    ("conv3_2", 256, 256),
    ("conv3_3", 256, 256),
    ("conv4_1", 256, 512),
    ("conv4_2", 512, 512),
)


def _max_pool(x, ceil_mode=False):
    """2x2 stride-2 max pool of NHWC ``x``; ceil mode keeps the ragged last
    row and column (the max over what lies inside the image)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1)


class VGG16(nn.Module):
    """Perceptual tap stack on ``device`` (``cuda`` unless given), weights
    drawn from ``generator``."""

    def __init__(self, *, policy: Optional[Policy] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.policy = policy or default_policy(device)
        for name, cin, cout in LAYERS:
            self.add_module(name, Conv2d(cin, cout, 3, 1, 1, device=device,
                                         generator=generator))

    def forward(self, x):
        out = x.to(self.policy.compute_dtype)
        taps = []
        for name, _, _ in LAYERS:
            out = torch.relu(getattr(self, name)(out))
            if name in ("conv1_1", "conv4_2"):
                taps.append(out)
            elif name == "conv1_2":
                taps.append(out)
                out = _max_pool(out)  # pool1
            elif name == "conv2_2":
                out = _max_pool(out)  # pool2
                taps.append(out)  # the reference's misnamed 'conv3_2' tap
            elif name == "conv3_3":
                out = _max_pool(out, ceil_mode=True)  # pool3
        return tuple(taps)


def perceptual_distance(feats_a, feats_b):
    """Sum of per-tap MSEs, accumulated in float32 (the reference's 4-term
    criterion sum, `attack_main2.py:626-635`)."""
    total = torch.zeros((), dtype=torch.float32, device=feats_a[0].device)
    for a, b in zip(feats_a, feats_b):
        d = a.float() - b.float()
        total = total + (d * d).mean()
    return total

"""ResNet classifier, the attacked model of the classifier-transfer PGD and
CW recipes (port of ``tpufusion/models/resnet.py``).

The reference attacks a torchvision ``resnet18`` with a 2-way head, the FFHQ
gender classifier (`interpolation.py:1296-1302`), always in ``eval()``. This
is that network on NHWC activations, with frozen (inference-mode) batch
norm and torchvision's state-dict names (``conv1``, ``bn1``,
``layer{s}.{b}.conv1/bn1/conv2/bn2``, ``layer{s}.{b}.downsample.0/1``,
``fc``), so a torchvision resnet18 state dict loads with
``load_state_dict``. The convs stay ``F.conv2d``: the JAX package leaves
them to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.models.e4e import Conv2d, FrozenBatchNorm, Linear


class BasicBlock(nn.Module):
    def __init__(self, cin, features, stride=1, *, device=None, generator=None):
        super().__init__()
        kw = dict(bias=False, device=device, generator=generator)
        self.conv1 = Conv2d(cin, features, 3, stride, 1, **kw)
        self.bn1 = FrozenBatchNorm(features, device=device)
        self.conv2 = Conv2d(features, features, 3, 1, 1, **kw)
        self.bn2 = FrozenBatchNorm(features, device=device)
        if cin != features or stride != 1:
            self.downsample = nn.Sequential(Conv2d(cin, features, 1, stride, 0, **kw),
                                            FrozenBatchNorm(features, device=device))
        else:
            self.downsample = None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        skip = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + skip)


class ResNet(nn.Module):
    """torchvision-layout ResNet of BasicBlocks (resnet18 / 34) on
    ``device`` (``cuda`` unless given), weights drawn from ``generator``:
    ``forward(images_nhwc) -> (N, num_classes)`` float32 logits."""

    def __init__(self, num_classes: int = 2, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 width: int = 64, *, policy: Optional[Policy] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.policy = policy or default_policy(device)
        self.stage_sizes = tuple(stage_sizes)
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv2d(3, width, 7, 2, 3, bias=False, **kw)
        self.bn1 = FrozenBatchNorm(width, device=device)
        cin = width
        for s, n_blocks in enumerate(self.stage_sizes):
            feats = width * 2 ** s
            blocks = []
            for b in range(n_blocks):
                blocks.append(BasicBlock(cin, feats, 2 if (s > 0 and b == 0) else 1, **kw))
                cin = feats
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))
        self.fc = Linear(cin, num_classes, **kw)

    def forward(self, x):
        dt = self.policy.compute_dtype
        y = torch.relu(self.bn1(self.conv1(x.to(dt))))
        # 3x3 stride-2 max pool; its padding is -inf
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for s in range(len(self.stage_sizes)):
            y = getattr(self, f"layer{s + 1}")(y)
        y = y.float().mean(dim=(1, 2))  # global average pool in float32
        # flax's Dense promotes the compute-dtype input and the float32
        # weights to float32
        return self.fc(y.to(dt).float())


def create_resnet18(num_classes: int = 2, *, policy: Optional[Policy] = None, device=None,
                    seed: int = 0) -> ResNet:
    """A resnet18 with seeded random weights, frozen, on ``device`` (``cuda``
    unless given)."""
    device = resolve_device(device)
    model = ResNet(num_classes, policy=policy, device=device,
                   generator=torch.Generator(device=device).manual_seed(seed))
    return model.requires_grad_(False)

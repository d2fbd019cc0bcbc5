"""The one generator of every traffic mix: a group's inputs from the seed.

A researcher's run attacks a dataset one group of N images at a time, each
group against one target image (`attack_main2.py:990-1111`). Group ``i`` of
a run gets N fresh images, a fresh target and a fresh ``torch.Generator``
for what the attack draws, all made on the device from ``(seed, i)``: the
same seed gives the same groups, and every seed gives groups of the same
sizes, so the seed changes the values and never the work.

The images are smooth random fields in [-1, 1]: a coarse normal grid
(``coarse`` a side) upsampled bicubically to the model's resolution, plus
fine normal detail (``detail``), through tanh. Real photos are not in the
repository; these give the encoder and the perceptual taps structure at
every scale.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.weights import mix

WARMUP_GROUP = -1  # the index of the set-up's group
SHORT_GROUP = -2  # the index of a mix's first short group (``check.short``); the k-th is -2 - k


def group_inputs(seed: int, index: int, n: int, size: int, mix_params: dict, device):
    """``(images (n, size, size, 3), target (1, size, size, 3), generator)``,
    float32 NHWC on ``device``; the generator is the one the runner hands
    the attack for what it draws."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, 1_000_000 + index))
    coarse = int(mix_params.get("coarse", 16))
    base = torch.randn(n + 1, 3, coarse, coarse, generator=gen, device=device)
    img = F.interpolate(base, size=(size, size), mode="bicubic", align_corners=False)
    detail = torch.randn(n + 1, 3, size, size, generator=gen, device=device)
    img = torch.tanh(img + float(mix_params.get("detail", 0.05)) * detail)
    img = img.permute(0, 2, 3, 1).contiguous()
    attack_gen = torch.Generator(device=device).manual_seed(mix(seed, 2_000_000 + index))
    return img[:n].contiguous(), img[n:].contiguous(), attack_gen


def checked_groups(seed: int, pool: int, count: int) -> list:
    """The groups whose answers are compared: ``count`` of the first
    ``pool`` group indices, drawn from the seed."""
    import random

    rng = random.Random(mix(seed, 7))
    return sorted(rng.sample(range(pool), min(count, pool)))

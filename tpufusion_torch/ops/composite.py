"""Masked patch composite: ``adv = (1-mask)*img + mask*patch``, clamped (port
of ``tpufusion/ops/composite.py``).

Reference: `attack_main2.py:413-419` (``patch_white_box``) and
`patch/adversarial_patch.py:106,137-138`. The clamp bounds default to the
min and max of the source image, as the reference clamps to
``[img.min(), img.max()]``. One elementwise pass that the JAX package leaves
to XLA (there is no Pallas kernel), so it stays plain PyTorch here.
"""

from __future__ import annotations

import torch


def masked_composite(img: torch.Tensor, patch: torch.Tensor, mask: torch.Tensor,
                     clip_min=None, clip_max=None) -> torch.Tensor:
    """Composite ``patch`` over ``img`` where ``mask`` is 1, then clamp to
    ``[clip_min, clip_max]`` (scalars or tensors that broadcast against the
    result; by default the min and max of ``img``)."""
    lo = img.min() if clip_min is None else torch.as_tensor(clip_min, device=img.device)
    hi = img.max() if clip_max is None else torch.as_tensor(clip_max, device=img.device)
    out = (1.0 - mask) * img + mask * patch
    return torch.minimum(torch.maximum(out, lo.to(out.dtype)), hi.to(out.dtype))

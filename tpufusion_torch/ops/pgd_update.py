"""Fused PGD update — grad-sign step + eps-ball projection + pixel clamp
(port of ``tpufusion/ops/pgd_update.py``).

    adv'  = clip(img + clip(adv + alpha * sign(grad) - img, -eps, eps), cmin, cmax)

Kernel: ``csrc/pgd_update.cu``, replacing the TPU kernel
``tpufusion/ops/pgd_update.py::pgd_update`` (``_pgd_kernel``). It is bound by
the bytes it moves (three reads and one write); one grid-stride pass with
16-byte loads is the whole design. The TPU kernel's ``size % 1024`` gate is
gone: any size is taken.

``pgd_update_plain`` is the same function in plain PyTorch; the wrapper uses
it for CPU tensors only.
"""

from __future__ import annotations

import torch

from tpufusion_torch.ops import _lib


def pgd_update_plain(adv, grad, images, alpha, eps, clip_min=-1.0, clip_max=1.0):
    """The math of the kernel in plain PyTorch: float32, cast back."""
    a, x = adv.float(), images.float()
    delta = (a + alpha * torch.sign(grad.float()) - x).clamp(-eps, eps)
    return (x + delta).clamp(clip_min, clip_max).to(adv.dtype)


def pgd_update_kernel(adv, grad, images, alpha, eps, clip_min=-1.0, clip_max=1.0):
    """Launch the kernel on contiguous CUDA tensors of one shape and dtype."""
    fn = _lib.load("pgd_update").tf_pgd_update
    for name, t in (("grad", grad), ("images", images)):
        if t.shape != adv.shape or t.dtype != adv.dtype or t.device != adv.device:
            raise ValueError(f"pgd_update: {name} must match adv in shape, dtype "
                             f"and device, got {tuple(t.shape)} {t.dtype} {t.device}")
    for name, t in (("adv", adv), ("grad", grad), ("images", images)):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"pgd_update: {name} must be a contiguous CUDA tensor")
    out = torch.empty_like(adv)
    ptrs = (adv.data_ptr(), grad.data_ptr(), images.data_ptr(), out.data_ptr())
    vectorized = int(all(p % 16 == 0 for p in ptrs))
    rc = fn(*ptrs, adv.numel(), _lib.dtype_code(adv),
            vectorized, float(alpha), float(eps), float(clip_min), float(clip_max),
            _lib.stream_ptr(adv))
    _lib.check(rc, "pgd_update")
    return out


def pgd_update(adv, grad, images, alpha, eps, clip_min=-1.0, clip_max=1.0):
    """One fused L-inf PGD step. ``clip_min``/``clip_max`` default to the
    [-1, 1] image range. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if adv.device.type == "cpu":
        return pgd_update_plain(adv, grad, images, alpha, eps, clip_min, clip_max)
    out = pgd_update_kernel(adv, grad, images, alpha, eps, clip_min, clip_max)
    pgd_update.launches += 1
    return out


pgd_update.launches = 0

"""Fused PGD update — grad-sign step + eps-ball projection + pixel clamp
(port of ``tpufusion/ops/pgd_update.py``).

    adv'  = clip(img + clip(adv + alpha * sign(grad) - img, -eps, eps), cmin, cmax)

Kernel: ``csrc/pgd_update.cu``, replacing the TPU kernel
``tpufusion/ops/pgd_update.py::pgd_update`` (``_pgd_kernel``). It is bound by
the bytes it moves (three reads and one write): 16-byte evict-first loads
and stores on a grid picked by size (``csrc/pixel_stream.cuh``). The TPU kernel's ``size % 1024`` gate is gone:
any size is taken.

``pgd_update_plain`` is the same function in plain PyTorch; the wrapper uses
it for CPU tensors only.
"""

from __future__ import annotations

import torch

from tpufusion_torch.core import trace
from tpufusion_torch.ops import _lib


def pgd_update_plain(adv, grad, images, alpha, eps, clip_min=-1.0, clip_max=1.0):
    """The math of the kernel in plain PyTorch: float32, cast back."""
    a, x = adv.float(), images.float()
    delta = (a + alpha * torch.sign(grad.float()) - x).clamp(-eps, eps)
    return (x + delta).clamp(clip_min, clip_max).to(adv.dtype)


def _check(name, t, like):
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"pgd_update: {name} must match adv in shape, dtype "
                         f"and device, got {tuple(t.shape)} {t.dtype} {t.device}")


def _check_cuda(name, t):
    if not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"pgd_update: {name} must be a contiguous CUDA tensor")


def pgd_update_kernel(adv, grad, images, alpha, eps, clip_min=-1.0, clip_max=1.0):
    """Launch the kernel on contiguous CUDA tensors of one shape and dtype;
    every check raises before the library is built or loaded. The output
    starts at adv's offset from a 16-byte boundary, so that a view of a few
    elements off still streams through the kernel's body."""
    _check("grad", grad, adv)
    _check("images", images, adv)
    _check_cuda("adv", adv)
    _check_cuda("grad", grad)
    _check_cuda("images", images)
    code = _lib.dtype_code(adv)
    fn = _lib.load("pgd_update").tf_pgd_update
    off = adv.data_ptr() % 16 // adv.element_size()
    if off:
        out = torch.empty(adv.numel() + off, dtype=adv.dtype, device=adv.device)[off:]
        out = out.view(adv.shape)
    else:
        out = torch.empty_like(adv)
    _lib.launch(fn, adv, "pgd_update", adv.data_ptr(), grad.data_ptr(), images.data_ptr(),
                out.data_ptr(), adv.numel(), code, float(alpha), float(eps),
                float(clip_min), float(clip_max))
    return out


def pgd_update(adv, grad, images, alpha, eps, clip_min=-1.0, clip_max=1.0):
    """One fused L-inf PGD step. ``clip_min``/``clip_max`` default to the
    [-1, 1] image range. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if adv.device.type == "cpu":
        return pgd_update_plain(adv, grad, images, alpha, eps, clip_min, clip_max)
    out = pgd_update_kernel(adv, grad, images, alpha, eps, clip_min, clip_max)
    trace.count("pgd_update")
    return out

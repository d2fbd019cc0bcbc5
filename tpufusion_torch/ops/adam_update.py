"""Fused Adam pixel update: moments, bias correction and step in one pass
(port of ``tpufusion/ops/adam_update.py``).

One ``optax.adam(lr)``-default step (b1 0.9, b2 0.999, eps 1e-8) over the
white-box attack's float32 pixel buffer (`attack_main2.py:614`
``optim.Adam([X])``):

    mu  <- b1*mu + (1-b1)*g          nu  <- b2*nu + (1-b2)*g*g
    x   <- x - lr * (mu / bc1) / (sqrt(nu / bc2) + eps)

with ``bc1 = 1 - b1**t`` and ``bc2 = 1 - b2**t`` computed once per step in
float32. This is the JAX package's order of operations, not
``torch.optim.Adam``'s (which divides by ``sqrt(bc2)`` outside the root and
differs by ulps).

Kernel: ``csrc/adam_update.cu``, replacing the TPU kernel
``tpufusion/ops/adam_update.py::_pallas_adam`` (``_adam_kernel``). It is
bound by the bytes it moves (four reads, three writes); one grid-stride pass
with 16-byte loads is the whole design. ``x``, ``mu`` and ``nu`` are updated
in place, as the TPU kernel aliases them. The TPU kernel's ``size % 1024``
gate is gone: any size is taken.

``adam_update_plain`` is the same step in plain PyTorch, rounding after every
operation as the kernel does; ``fused_adam`` uses it for CPU tensors only.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufusion_torch.ops import _lib

B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_init(x: torch.Tensor) -> dict:
    """Moment state for ``fused_adam``: zero moments and a step count kept as
    a Python int, so the loop never waits on the device."""
    return dict(mu=torch.zeros_like(x), nu=torch.zeros_like(x), count=0)


def bias_corrections(count: int):
    """``(1 - b1**t, 1 - b2**t)`` in float32 for step ``t = count``."""
    t = np.float32(count)
    one = np.float32(1.0)
    return float(one - np.float32(B1) ** t), float(one - np.float32(B2) ** t)


def adam_update_plain(x, g, mu, nu, lr, bc1, bc2):
    """The kernel's arithmetic in plain PyTorch, in place on ``x``, ``mu``
    and ``nu``. The bias corrections divide as 0-dim tensors on ``x``'s
    device: a Python scalar divisor would become a multiply by its
    reciprocal on CUDA and round differently."""
    bc1_t = torch.tensor(bc1, dtype=torch.float32, device=x.device)
    bc2_t = torch.tensor(bc2, dtype=torch.float32, device=x.device)
    mu.mul_(B1).add_(g * (1.0 - B1))
    nu.mul_(B2).add_(g * (1.0 - B2) * g)
    step = (mu / bc1_t) / ((nu / bc2_t).sqrt() + EPS)
    x.sub_(step * lr)
    return x, mu, nu


def adam_update_kernel(x, g, mu, nu, lr, bc1, bc2):
    """Launch the kernel on contiguous float32 CUDA tensors of one shape;
    ``x``, ``mu`` and ``nu`` are written in place."""
    fn = _lib.load("adam_update").tf_adam_update
    for name, t in (("x", x), ("g", g), ("mu", mu), ("nu", nu)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adam: {name} must be float32, got {t.dtype}")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"fused_adam: {name} must match x in shape and device, "
                             f"got {tuple(t.shape)} {t.device}")
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"fused_adam: {name} must be a contiguous CUDA tensor")
    ptrs = (x.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr())
    vectorized = int(all(p % 16 == 0 for p in ptrs))
    rc = fn(*ptrs, x.numel(), vectorized, float(lr), float(bc1), float(bc2),
            _lib.stream_ptr(x))
    _lib.check(rc, "fused_adam")
    return x, mu, nu


def fused_adam(x: torch.Tensor, g: torch.Tensor, state: dict, lr):
    """One Adam step over a pixel buffer, in place on ``x`` and the moments.
    Returns ``(x, state)`` with the step count advanced. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    count = state["count"] + 1
    bc1, bc2 = bias_corrections(count)
    if x.device.type == "cpu":
        adam_update_plain(x, g, state["mu"], state["nu"], lr, bc1, bc2)
    else:
        adam_update_kernel(x, g, state["mu"], state["nu"], lr, bc1, bc2)
        fused_adam.launches += 1
    return x, dict(mu=state["mu"], nu=state["nu"], count=count)


fused_adam.launches = 0

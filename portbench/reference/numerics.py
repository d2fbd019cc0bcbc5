"""How the reference computes its products: in float32, or as the control.

Every convolution and linear layer of the reference models goes through a
``Numerics`` object. ``Numerics("float32")`` is plain float32 (the caller
turns TF32 off). ``Numerics("float8")`` is the control of the comparison
that decides ``correct``: the step below the port's stated bfloat16 compute.
It follows the usual float8 recipe: each product's operands (activations and
weights) are rounded to e4m3 with one scale per tensor (its absolute
maximum onto 448), and the gradient arriving at each product's output is
rounded to e5m2 (its maximum onto 57344) before the backward products use
it. Everything else (normalisation, activations, the losses, the optimiser)
stays float32.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_to(x: torch.Tensor, dtype: torch.dtype, fmax: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under one scale for the whole
    tensor, returned in ``x``'s dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = fmax / amax
    return (x.float() * scale).to(dtype).float().div(scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Forward: e4m3. Backward: the gradient passes unchanged (it is rounded
    where it enters a product, by ``_OutputGrad``)."""

    @staticmethod
    def forward(ctx, x):
        return _round_to(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _OutputGrad(torch.autograd.Function):
    """Forward: identity. Backward: the output's gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, torch.float8_e5m2, E5M2_MAX)


class Numerics:
    """``precision`` is ``"float32"`` or ``"float8"``."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"precision must be float32 or float8, got {precision!r}")
        self.precision = precision

    def _product(self, fn, x, w, *args, **kwargs):
        if self.precision == "float32":
            return fn(x, w, *args, **kwargs)
        y = fn(_Operand.apply(x), _Operand.apply(w), *args, **kwargs)
        return _OutputGrad.apply(y)

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        y = self._product(F.conv2d, x, w, None, stride=stride, padding=padding)
        return y if b is None else y + b.view(1, -1, 1, 1)

    def conv_transpose2d(self, x, w, stride=2):
        return self._product(F.conv_transpose2d, x, w, None, stride=stride)

    def linear(self, x, w, b=None):
        y = self._product(F.linear, x, w)
        return y if b is None else y + b


FLOAT32 = Numerics("float32")


@contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN, restored
    on leaving."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

"""bf16 rounding parity of the conv kernels' plain twins with the TPU kernels.

The same numpy inputs, cast to bfloat16, go through the port's plain twins
(``styled_conv_plain``, ``conv3x3_plain``, ``conv3x3_input_grad_plain``,
``conv3x3_weight_grad_plain``) on the CPU and through the JAX package's
Pallas kernels in interpret mode (``_pallas_styled_conv``,
``pallas_conv.conv3x3_wp`` and its VJP). These pin
the rounding points that the Hopper bf16 kernel follows, and that
``chip_smoke.py`` phase 3 holds it to: the modulated input ``x * bf16(s)``
rounded to bf16, float32 sums, the output rounded to bf16.

Tolerances, on max|diff| / max|JAX|:
- conv3x3 forward and input grad: 8e-3, two bf16 ulps (2^-8 each). Both
  sides sum bf16 products in float32 and round once; the order of the f32
  sums differs, which can move a rounding by one ulp.
- conv3x3 weight grad: both sides add exact bf16 products in float32. The
  TPU kernel's float32 sums (``_conv3x3_wp_dw_impl`` + ``unpack_dw`` to
  float32) differ from the plain twin's only by the order of the sums:
  1e-5. ``jax.grad`` of ``conv3x3_wp`` then rounds dw to the bf16 weight's
  dtype, half a bf16 ulp of an entry (2^-9 of max|dw| at most): 4e-3, one
  bf16 ulp; the plain twin rounded the same way agrees to the same bound.
- styled_conv: 2e-2. The TPU kernel rounds its float32 epilogue once; the
  plain twin rounds the conv, the demodulation, the noise and the bias
  adds and the activation each to bf16 (about five half-ulp roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufusion.ops import pallas_conv as jpc
from tpufusion.ops.styled_conv import _pallas_styled_conv
from tpufusion_torch.ops import conv3x3 as c3
from tpufusion_torch.ops import styled_conv as sc

CONV_TOL = 8e-3
WGRAD_F32_TOL = 1e-5
WGRAD_BF16_TOL = 4e-3
STYLED_TOL = 2e-2


def _np(shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + offset).astype(np.float32)


def _bf16_np(a):
    """Round a float32 array to bf16 (as torch does) and back to float32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def interpret():
    jpc.set_interpret(True)
    yield
    jpc.set_interpret(False)


@pytest.mark.parametrize("n,h,cin,cout", [(2, 16, 32, 64), (1, 16, 64, 32)])
def test_styled_conv_plain_bf16_matches_pallas(n, h, cin, cout):
    x = _bf16_np(_np((n, h, h, cin), 60))
    w = _np((3, 3, cin, cout), 61)
    s = _np((n, cin), 62, 0.3, 1.0)
    noise = _np((1, h, h, 1), 63)
    ns = np.float32(0.3)
    b = _np((cout,), 64, 0.1)
    y_j = _pallas_styled_conv(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (w, s, noise, ns, b)),
                              interpret=True)
    assert y_j.dtype == jnp.bfloat16
    y_t = sc.styled_conv_plain(torch.from_numpy(x).bfloat16(),
                               *map(torch.from_numpy, (w, s, noise, np.array(ns), b)))
    assert y_t.dtype == torch.bfloat16
    assert _rel(y_t.float().numpy(), np.asarray(y_j, np.float32)) <= STYLED_TOL


@pytest.mark.parametrize("n,h,w,c", [(1, 16, 16, 32), (2, 16, 8, 64)])
def test_conv3x3_plain_bf16_matches_pallas(interpret, n, h, w, c):
    x = _bf16_np(_np((n, h, w, c), 70))
    wt = _bf16_np(_np((3, 3, c, c), 71, 1 / np.sqrt(9 * c)))
    g = _bf16_np(_np((n, h, w, c), 72))
    xj, wj, gj = (jnp.asarray(a, jnp.bfloat16) for a in (x, wt, g))
    y_j, vjp = jax.vjp(lambda a: jpc.conv3x3_wp(a, wj), xj)
    (dx_j,) = vjp(gj)
    xt, wtt, gt = (torch.from_numpy(a).bfloat16() for a in (x, wt, g))
    y_t = c3.conv3x3_plain(xt, wtt)
    dx_t = c3.conv3x3_input_grad_plain(gt, wtt)
    assert y_t.dtype == dx_t.dtype == torch.bfloat16
    assert _rel(y_t.float().numpy(), np.asarray(y_j, np.float32)) <= CONV_TOL
    assert _rel(dx_t.float().numpy(), np.asarray(dx_j, np.float32)) <= CONV_TOL


@pytest.mark.parametrize("n,h,w,c", [(1, 16, 16, 32), (2, 32, 16, 32), (1, 16, 8, 64),
                                     (2, 16, 16, 64)])
def test_conv3x3_weight_grad_plain_bf16_matches_pallas(interpret, n, h, w, c):
    x = _bf16_np(_np((n, h, w, c), 80))
    wt = _bf16_np(_np((3, 3, c, c), 81, 1 / np.sqrt(9 * c)))
    g = _bf16_np(_np((n, h, w, c), 82))
    xj, wj, gj = (jnp.asarray(a, jnp.bfloat16) for a in (x, wt, g))
    # the gradient a user gets: jax.grad of conv3x3_wp, dw in the weight's bf16
    dw_j = jax.grad(lambda b: jnp.sum(jpc.conv3x3_wp(xj, b).astype(jnp.float32)
                                      * gj.astype(jnp.float32)))(wj)
    assert dw_j.dtype == jnp.bfloat16
    # the TPU kernel's own float32 sums, before that rounding
    dw_j32 = jpc.unpack_dw(jpc._conv3x3_wp_dw_impl(xj, gj, c), c, jnp.float32)
    xt, gt = (torch.from_numpy(a).bfloat16() for a in (x, g))
    dw_t = c3.conv3x3_weight_grad_plain(xt, gt)
    assert dw_t.dtype == torch.float32 and tuple(dw_t.shape) == (3, 3, c, c)
    assert _rel(dw_t.numpy(), np.asarray(dw_j32)) <= WGRAD_F32_TOL
    assert _rel(dw_t.numpy(), np.asarray(dw_j, np.float32)) <= WGRAD_BF16_TOL
    assert _rel(dw_t.bfloat16().float().numpy(), np.asarray(dw_j, np.float32)) <= WGRAD_BF16_TOL
    # the wrapper on CPU tensors: autograd of the plain conv, dw in bf16 too
    wa = torch.from_numpy(wt).bfloat16().requires_grad_(True)
    (dw_a,) = torch.autograd.grad(c3.conv3x3(xt, wa), wa, gt)
    assert dw_a.dtype == torch.bfloat16
    assert _rel(dw_a.float().numpy(), np.asarray(dw_j, np.float32)) <= WGRAD_BF16_TOL

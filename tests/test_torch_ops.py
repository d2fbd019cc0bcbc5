"""Parity of the port's ops (``tpufusion_torch.ops``) with the JAX package.

Inputs come from a seeded numpy generator and go through the JAX function and
its port; everything runs on the CPU in float32, where each kernel wrapper
takes its plain PyTorch version. Tolerance: atol = rtol = 2e-4 (the goldens'
bar, tests/test_goldens.py) unless a case states otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tpufusion.ops import pallas_conv as jpc
from tpufusion.ops.modconv import modulated_conv2d as j_modconv
from tpufusion.ops.pgd_update import pgd_update as j_pgd
from tpufusion.ops.styled_conv import _pallas_styled_conv, styled_conv_reference as j_sc_ref
from tpufusion.ops.upfirdn2d import (
    blur as j_blur,
    make_blur_kernel as j_kernel,
    upfirdn2d as j_upfirdn,
    upsample_2x as j_up,
)
from tpufusion_torch import ops
from tpufusion_torch.ops import conv3x3 as c3
from tpufusion_torch.ops import pgd_update as pu
from tpufusion_torch.ops import styled_conv as sc

TOL = dict(atol=2e-4, rtol=2e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(shape, seed, scale=1.0, offset=0.0):
    return (_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestUpfirdn2d:
    @pytest.mark.parametrize("up,down,pad", [
        (1, 1, (2, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (1, 1)),
        (1, 1, (-1, 2)), (1, 2, (-1, 1)), (2, 1, (0, 3)),
    ])
    def test_upfirdn2d_matches_jax(self, up, down, pad):
        x = _np((2, 9, 9, 3), 0)
        gain = 4.0 if up == 2 else 1.0
        y_j = j_upfirdn(jnp.asarray(x), j_kernel((1, 3, 3, 1), gain), up=up, down=down, pad=pad)
        y_t = ops.upfirdn2d(_t(x), ops.make_blur_kernel((1, 3, 3, 1), gain), up=up,
                            down=down, pad=pad)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)

    def test_resamplers_match_jax(self):
        x = _np((2, 8, 8, 5), 1)
        xj, xt = jnp.asarray(x), _t(x)
        np.testing.assert_allclose(ops.upsample_2x(xt).numpy(), np.asarray(j_up(xj)),
                                   atol=1e-5, rtol=1e-5)
        k = (1, 3, 3, 1)
        np.testing.assert_allclose(
            ops.blur(xt, ops.make_blur_kernel(k, 4.0), (2, 1)).numpy(),
            np.asarray(j_blur(xj, j_kernel(k, 4.0), (2, 1))), atol=1e-5, rtol=1e-5)


class TestModulatedConv:
    @pytest.mark.parametrize("k,cin,cout,up,down,demod", [
        (3, 8, 6, False, False, True),
        (3, 8, 6, False, False, False),
        (3, 8, 6, True, False, True),
        (3, 8, 6, False, True, True),
        (1, 8, 3, False, False, False),
        (3, 32, 32, False, False, True),  # routed through ops.conv3x3
    ])
    def test_matches_jax(self, k, cin, cout, up, down, demod):
        x = _np((2, 8, 8, cin), 2)
        w = _np((k, k, cin, cout), 3)
        s = _np((2, cin), 4, 0.3, 1.0)
        y_j = j_modconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), demodulate=demod,
                        up=up, down=down)
        y_t = ops.modulated_conv2d(_t(x), _t(w), _t(s), demodulate=demod, up=up, down=down)
        assert tuple(y_t.shape) == y_j.shape
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


@pytest.fixture
def interpret():
    jpc.set_interpret(True)
    yield
    jpc.set_interpret(False)


class TestConv3x3:
    @pytest.mark.parametrize("n,h,w,c", [(1, 24, 8, 32), (2, 16, 8, 32), (1, 24, 4, 64)])
    def test_plain_matches_pallas_interpret(self, interpret, n, h, w, c):
        x = _np((n, h, w, c), 5)
        wt = _np((3, 3, c, c), 6, 0.1)
        g = _np((n, h, w, c), 7)
        xj, wj, gj = map(jnp.asarray, (x, wt, g))
        y_j = jpc.conv3x3_wp(xj, wj)
        dx_j, dw_j = jax.grad(lambda a, b: jnp.sum(jpc.conv3x3_wp(a, b) * gj), (0, 1))(xj, wj)
        xt, wtt, gt = _t(x), _t(wt), _t(g)
        np.testing.assert_allclose(c3.conv3x3_plain(xt, wtt).numpy(), np.asarray(y_j), **TOL)
        np.testing.assert_allclose(c3.conv3x3_input_grad_plain(gt, wtt).numpy(),
                                   np.asarray(dx_j), **TOL)
        np.testing.assert_allclose(c3.conv3x3_weight_grad_plain(xt, gt).numpy(),
                                   np.asarray(dw_j), **TOL)
        # the wrapper on CPU tensors: the plain version and its autograd
        xa, wa = xt.clone().requires_grad_(True), wtt.clone().requires_grad_(True)
        dx_t, dw_t = torch.autograd.grad(c3.conv3x3(xa, wa), (xa, wa), gt)
        np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), **TOL)
        np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j), **TOL)

    def test_supported_shapes(self):
        assert c3.supported((1, 1024, 1024, 32), (3, 3, 32, 32))
        assert c3.supported((2, 512, 512, 64), (3, 3, 64, 64))
        assert c3.supported((1, 5, 7, 32), (3, 3, 32, 32))  # no TPU width/row limits
        assert not c3.supported((1, 8, 8, 64), (3, 3, 64, 32))
        assert not c3.supported((1, 8, 8, 128), (3, 3, 128, 128))
        assert not c3.supported((1, 8, 8, 32), (1, 1, 32, 32))


def _sc_inputs(n, h, cin, cout, seed=10):
    return (_np((n, h, h, cin), seed), _np((3, 3, cin, cout), seed + 1),
            _np((n, cin), seed + 2, 0.3, 1.0), _np((1, h, h, 1), seed + 3),
            np.float32(0.3), _np((cout,), seed + 4, 0.1))


class TestStyledConv:
    @pytest.mark.parametrize("n,h,cin,cout", [(2, 16, 32, 64), (1, 16, 64, 32)])
    def test_plain_matches_pallas_interpret_and_composite(self, n, h, cin, cout):
        args = _sc_inputs(n, h, cin, cout)
        jargs = tuple(map(jnp.asarray, args))
        y_pallas = _pallas_styled_conv(*jargs, interpret=True)
        y_ref = j_sc_ref(*jargs)
        targs = tuple(map(_t, args))
        for fn in (sc.styled_conv_plain, sc.styled_conv_reference, sc.styled_conv):
            y = fn(*targs).numpy()
            np.testing.assert_allclose(y, np.asarray(y_pallas), **TOL)
            np.testing.assert_allclose(y, np.asarray(y_ref), **TOL)

    @pytest.mark.parametrize("h", [4, 8])
    def test_small_planes_match_composite(self, h):
        """4^2 and 8^2: the Hopper kernel takes them (the TPU dispatcher did not)."""
        args = _sc_inputs(2, h, 32, 32, seed=20)
        assert sc.supported(args[0].shape, args[1].shape, args[3].shape)
        y_ref = j_sc_ref(*map(jnp.asarray, args))
        np.testing.assert_allclose(sc.styled_conv_plain(*map(_t, args)).numpy(),
                                   np.asarray(y_ref), **TOL)

    def test_grads_match_jax(self):
        x, w, s, noise, ns, b = _sc_inputs(2, 8, 32, 32, seed=30)
        g = _np((2, 8, 8, 32), 40)
        wj, nj, nsj, bj, gj = map(jnp.asarray, (w, noise, ns, b, g))
        dx_j, ds_j = jax.grad(lambda a, c: jnp.sum(j_sc_ref(a, wj, c, nj, nsj, bj) * gj),
                              (0, 1))(jnp.asarray(x), jnp.asarray(s))
        xt, st = _t(x).requires_grad_(True), _t(s).requires_grad_(True)
        y = sc.styled_conv(xt, _t(w), st, _t(noise), _t(ns), _t(b))
        dx_t, ds_t = torch.autograd.grad(y, (xt, st), _t(g))
        np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), **TOL)
        np.testing.assert_allclose(ds_t.numpy(), np.asarray(ds_j), atol=1e-3, rtol=2e-4)

    def test_supported_shapes(self):
        assert sc.supported((1, 4, 4, 512), (3, 3, 512, 512), (1, 4, 4, 1))
        assert sc.supported((1, 1024, 1024, 32), (3, 3, 32, 32), (1, 1024, 1024, 1))
        # per-sample noise and 1x1 kernels stay on the composite
        assert not sc.supported((2, 8, 8, 32), (3, 3, 32, 32), (2, 8, 8, 1))
        assert not sc.supported((1, 8, 8, 32), (1, 1, 32, 32), (1, 8, 8, 1))
        assert not sc.supported((1, 8, 8, 32), (3, 3, 32, 3), (1, 8, 8, 1))


class TestPGDUpdate:
    @pytest.mark.parametrize("shape", [(2, 16, 16, 3), (3, 7, 5, 3)])
    def test_matches_jax(self, shape):
        adv = np.clip(_np(shape, 50, 0.5), -1, 1)
        img = np.clip(adv + _np(shape, 51, 0.02), -1, 1)
        grad = _np(shape, 52)
        grad.flat[::7] = 0.0  # sign(0) == 0
        y_j = j_pgd(*map(jnp.asarray, (adv, grad, img)), 0.02, 16 / 255, -1.0, 1.0)
        y_t = pu.pgd_update(_t(adv), _t(grad), _t(img), 0.02, 16 / 255, -1.0, 1.0)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6, rtol=0)
        assert np.abs(y_t.numpy() - img).max() <= 16 / 255 + 1e-6

    def test_cpu_launches_no_kernel(self):
        ops.reset_launch_counts()
        t = torch.zeros(2, 4, 4, 3)
        pu.pgd_update(t, t, t, 0.1, 0.1)
        c3.conv3x3(torch.zeros(1, 4, 4, 32), torch.zeros(3, 3, 32, 32))
        assert set(ops.launch_counts().values()) == {0}

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
from tpufusion.ops.styled_conv import _pallas_styled_conv, noise_bias_act as j_nba
from tpufusion.ops.styled_conv import styled_conv_reference as j_sc_ref
from tpufusion.ops.upfirdn2d import (
    blur as j_blur,
    make_blur_kernel as j_kernel,
    upfirdn2d as j_upfirdn,
    upsample_2x as j_up,
)
from tpufusion_torch import ops
from tpufusion_torch.ops import _lib
from tpufusion_torch.ops import adam_update as au
from tpufusion_torch.ops import conv3x3 as c3
from tpufusion_torch.ops import pgd_update as pu
from tpufusion_torch.ops import styled_conv as sc
from tpufusion_torch.ops.modconv import modulated_conv2d_up_folded, modulated_conv2d_up_plain

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


# the up convs of the tiny (32^2, channel multiplier 1) generator, then odd
# and even planes of other widths, 1^2 included: (n, h, w, cin, cout)
UP_CASES = [(2, 4, 4, 512, 512), (2, 8, 8, 512, 512), (1, 16, 16, 512, 512), (2, 5, 7, 16, 24),
            (1, 1, 1, 32, 16), (3, 9, 6, 48, 32)]


@pytest.mark.parametrize("n,h,w,cin,cout", UP_CASES)
def test_folded_up_conv_matches_the_plain_twin(n, h, w, cin, cout):
    """The up conv folded (one same conv on the phase weights,
    depth-to-space) against the transposed conv and blur it replaces, in
    float32: the forward and the gradients with respect to x and the style
    at 1e-5 of each one's largest entry. (Float32 synthesis runs the
    unfolded chain; bf16 the folded one.)"""
    x = _t(_np((n, h, w, cin), 70)).requires_grad_(True)
    s = _t(_np((n, cin), 71, 0.3, 1.0)).requires_grad_(True)
    wt = _t(_np((3, 3, cin, cout), 72))
    g = _t(_np((n, 2 * h, 2 * w, cout), 73))
    outs = []
    for fn in (lambda a, b: modulated_conv2d_up_folded(a, wt, b),
               lambda a, b: modulated_conv2d_up_plain(a, wt, b)):
        y = fn(x, s)
        outs.append((y.detach(), *torch.autograd.grad(y, (x, s), g)))
    assert tuple(outs[0][0].shape) == (n, 2 * h, 2 * w, cout)
    for got, want in zip(*outs):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _bwd_inputs(n, h, w, cin, cout, up, seed):
    oh, ow = (2 * h, 2 * w) if up else (h, w)
    return (_np((n, h, w, cin), seed), _np((3, 3, cin, cout), seed + 1),
            _np((n, cin), seed + 2, 0.3, 1.0), _np((1, oh, ow, 1), seed + 3), np.float32(0.3),
            _np((cout,), seed + 4, 0.1), _np((n, oh, ow, cout), seed + 5))


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# the analytic backward's twin (n, h, w, cin, cout, up): planes not a
# multiple of any tile, 1^2, Cout 96 (three 32-channel slices), the up
# conv's Co 8-24 (an 8-channel part or a block holding several phases)
BWD_TWIN_CASES = [(2, 8, 8, 32, 64, False), (1, 5, 7, 64, 32, False), (2, 3, 9, 32, 96, False),
                  (1, 1, 1, 32, 32, False), (2, 4, 4, 32, 8, True), (1, 5, 3, 64, 16, True),
                  (2, 6, 5, 32, 24, True), (1, 1, 1, 32, 32, True)]


@pytest.mark.parametrize("n,h,w,cin,cout,up", BWD_TWIN_CASES)
def test_backward_twin_matches_autograd_of_the_composite(n, h, w, cin, cout, up):
    """``styled_conv_backward_plain`` (what the backward kernels compute) in
    float32 against autograd of the composite, ``styled_conv_reference``
    and, for the up conv, the unfolded ``styled_conv_up_plain``: gx and gs
    within 1e-5 of each one's largest entry; with x needing no gradient (the
    4^2 constant input) the composite's gs alone is the same."""
    x, wt, s, noise, ns, b, g = map(_t, _bwd_inputs(n, h, w, cin, cout, up, 80))
    ref = sc.styled_conv_up_plain if up else sc.styled_conv_reference
    xa, sa = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    want = torch.autograd.grad(ref(xa, wt, sa, noise, ns, b), (xa, sa), g)
    got = sc.styled_conv_backward_plain(x, wt, s, noise, ns, b, g, up=up)
    assert got[0].dtype == x.dtype and got[1].dtype == s.dtype
    for a, e in zip(got, want):
        assert _rel_max(a, e) <= 1e-5
    sa = s.clone().requires_grad_(True)
    (gs,) = torch.autograd.grad(ref(x, wt, sa, noise, ns, b), (sa,), g)
    assert _rel_max(got[1], gs) <= 1e-5


@pytest.mark.parametrize("up", [False, True])
def test_backward_twin_matches_jax(up):
    """The twin against JAX's vjp of its composite (the up conv: JAX's
    transposed conv and blur) on a 32^2 output plane, 2e-4 of each
    gradient's largest entry."""
    h = 16 if up else 32
    x, wt, s, noise, ns, b, g = _bwd_inputs(2, h, h, 32, 32, up, 90)
    consts = tuple(map(jnp.asarray, (wt, noise, ns, b)))

    def composite(a, c):
        wj, nj, nsj, bj = consts
        if not up:
            return j_sc_ref(a, wj, c, nj, nsj, bj)
        return j_nba(j_modconv(a, wj, c, demodulate=True, up=True), nj, nsj, bj)
    _, vjp = jax.vjp(composite, jnp.asarray(x), jnp.asarray(s))
    want = vjp(jnp.asarray(g))
    got = sc.styled_conv_backward_plain(*map(_t, (x, wt, s, noise, ns, b, g)), up=up)
    for a, e in zip(got, want):
        assert _rel_max(a.numpy(), e) <= 2e-4


@pytest.mark.parametrize("up", [False, True])
def test_backward_twin_takes_the_given_sign_of_z(up):
    """``positive`` stands in for z > 0, and z enters the twin nowhere else:
    the composite's own y > 0 gives the twin's numbers, and z > 0 everywhere
    gives those of a bias that puts every z above 0 (float64)."""
    x, wt, s, noise, ns, b, g = (_t(a).double() for a in _bwd_inputs(2, 5, 6, 32, 16, up, 97))
    ref = sc.styled_conv_up_reference if up else sc.styled_conv_reference
    own = sc.styled_conv_backward_plain(x, wt, s, noise, ns, b, g, up=up)
    y = ref(x, wt, s, noise, ns, b)
    for a, e in zip(sc.styled_conv_backward_plain(x, wt, s, noise, ns, b, g, up=up,
                                                  positive=y > 0), own):
        assert torch.equal(a, e)
    high = sc.styled_conv_backward_plain(x, wt, s, noise, ns, b + 1e4, g, up=up)
    for a, e in zip(sc.styled_conv_backward_plain(x, wt, s, noise, ns, b, g, up=up,
                                                  positive=torch.ones_like(y, dtype=bool)), high):
        assert torch.equal(a, e) and not torch.equal(a, own[0 if a.dim() == 4 else 1])


def test_backward_routing():
    """``backward_takes_kernels``: the two kernels for bf16 CUDA tensors of
    the forward kernels' shapes with Cin % 32 == 0, asked for the gradient
    of x and the style, or of the style alone; the recomputed composite for
    the CPU, float32, K2's shapes (the up tests' Cin 16 and 48), per-sample
    noise, and any gradient of the weights, noise, its strength or bias."""
    bf16, f32 = torch.bfloat16, torch.float32
    xs = (True, False, True, False, False, False)
    conv = ((5, 1024, 1024, 32), (3, 3, 32, 32), (1, 1024, 1024, 1), False)
    up = ((5, 512, 512, 64), (3, 3, 64, 32), (1, 1024, 1024, 1), True)
    for shapes in (conv, up, ((1, 4, 4, 512), (3, 3, 512, 512), (1, 4, 4, 1), False),
                   ((2, 13, 13, 64), (3, 3, 64, 8), (1, 26, 26, 1), True)):
        assert sc.backward_takes_kernels(xs, "cuda", bf16, *shapes)
        assert sc.backward_takes_kernels((False, *xs[1:]), "cuda", bf16, *shapes)
        assert not sc.backward_takes_kernels(xs, "cpu", bf16, *shapes)
        assert not sc.backward_takes_kernels(xs, "cuda", f32, *shapes)
        for i in (1, 3, 4, 5):
            need = tuple(v or j == i for j, v in enumerate(xs))
            assert not sc.backward_takes_kernels(need, "cuda", bf16, *shapes)
    for shapes in (((2, 33, 17, 16), (3, 3, 16, 24), (1, 66, 34, 1), True),
                   ((4, 30, 20, 48), (3, 3, 48, 48), (1, 60, 40, 1), True),
                   ((1, 9, 21, 48), (3, 3, 48, 128), (1, 9, 21, 1), False),
                   ((2, 8, 8, 32), (3, 3, 32, 32), (2, 8, 8, 1), False),
                   ((2, 4, 4, 32), (3, 3, 32, 32), (2, 8, 8, 1), True)):
        assert not sc.backward_takes_kernels(xs, "cuda", bf16, *shapes)


def test_cpu_backward_recomputes_the_composite_uncounted():
    """On the CPU the operators' backward is autograd of the composite (the
    numbers the port gave before the kernels), counted nowhere: the CPU
    launches no kernel and the fallback count is the card's."""
    x, wt, s, noise, ns, b, g = (_t(a) for a in _bwd_inputs(1, 4, 4, 32, 32, False, 95))
    x, g = x.bfloat16(), g.bfloat16()
    ops.reset_launch_counts()
    xa, sa = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    got = torch.autograd.grad(sc.styled_conv(xa, wt, sa, noise, ns, b), (xa, sa), g)
    xr, sr = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    want = torch.autograd.grad(sc.styled_conv_reference(xr, wt, sr, noise, ns, b), (xr, sr), g)
    assert all(torch.equal(a, e) for a, e in zip(got, want))
    assert set(ops.launch_counts().values()) == {0}


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

    def test_up_supported_shapes(self):
        """The up kernel takes bf16, 3x3, Cin % 16 == 0, 4 Cout % 32 == 0 and
        one shared noise plane at the output's (2H, 2W)."""
        bf16 = torch.bfloat16
        assert sc.up_supported((5, 512, 512, 64), (3, 3, 64, 32), (1, 1024, 1024, 1), bf16)
        assert sc.up_supported((1, 4, 4, 512), (3, 3, 512, 512), (1, 8, 8, 1), bf16)
        assert sc.up_supported((2, 5, 7, 16), (3, 3, 16, 24), (1, 10, 14, 1), bf16)
        assert not sc.up_supported((1, 4, 4, 512), (3, 3, 512, 512), (1, 8, 8, 1),
                                   torch.float32)
        assert not sc.up_supported((2, 4, 4, 32), (3, 3, 32, 32), (2, 8, 8, 1), bf16)
        assert not sc.up_supported((1, 4, 4, 32), (3, 3, 32, 32), (1, 4, 4, 1), bf16)
        assert not sc.up_supported((1, 4, 4, 24), (3, 3, 24, 32), (1, 8, 8, 1), bf16)
        assert not sc.up_supported((1, 4, 4, 32), (3, 3, 32, 12), (1, 8, 8, 1), bf16)
        assert not sc.up_supported((1, 4, 4, 32), (1, 1, 32, 32), (1, 8, 8, 1), bf16)

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


def _planes(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


def _strided(*shape):
    """A view of ``shape`` that is not contiguous (channels moved last)."""
    n, h, w, c = shape
    return torch.zeros(n, c, h, w).permute(0, 2, 3, 1)


# what each kernel wrapper refuses: (the arguments changed from matching CPU
# planes, the exception, its message)
PGD_REFUSED = {
    "cpu": ({}, ValueError, "adv must be a contiguous CUDA tensor"),
    "meta": ({k: _planes(2, 4, 4, 3, device="meta") for k in ("adv", "grad", "images")},
             ValueError, "adv must be a contiguous CUDA tensor"),
    "shape": ({"grad": _planes(2, 4, 4, 2)}, ValueError, "grad must match adv"),
    "dtype": ({"images": _planes(2, 4, 4, 3, dtype=torch.bfloat16)}, ValueError,
              "images must match adv"),
    "non-contiguous": ({k: _strided(2, 4, 4, 3) for k in ("adv", "grad", "images")},
                       ValueError, "adv must be a contiguous CUDA tensor"),
}
ADAM_REFUSED = {
    "cpu": ({}, ValueError, "x must be a contiguous CUDA tensor"),
    "meta": ({k: _planes(2, 4, 4, 3, device="meta") for k in ("x", "g", "mu", "nu")},
             ValueError, "x must be a contiguous CUDA tensor"),
    "shape": ({"mu": _planes(2, 4, 4, 2)}, ValueError, "mu must match x"),
    "dtype": ({"g": _planes(2, 4, 4, 3, dtype=torch.bfloat16)}, TypeError,
              "g must be float32"),
    "non-contiguous": ({k: _strided(2, 4, 4, 3) for k in ("x", "g", "mu", "nu")},
                       ValueError, "x must be a contiguous CUDA tensor"),
}


@pytest.fixture
def no_build(monkeypatch):
    """Records every call that would build or load a kernel library."""
    calls = []
    monkeypatch.setattr(_lib, "load", lambda name: calls.append(("load", name)))
    monkeypatch.setattr(_lib, "build", lambda *a, **k: calls.append(("build", a)))
    return calls


@pytest.mark.parametrize("case", list(PGD_REFUSED))
def test_pgd_kernel_refuses_before_any_build(no_build, case):
    """``pgd_update_kernel`` raises on tensors off the card, mismatched
    shapes or dtypes and non-contiguous inputs before it builds, loads or
    launches anything."""
    change, exc, msg = PGD_REFUSED[case]
    planes = dict(adv=_planes(2, 4, 4, 3), grad=_planes(2, 4, 4, 3), images=_planes(2, 4, 4, 3))
    with pytest.raises(exc, match=msg):
        pu.pgd_update_kernel(**{**planes, **change}, alpha=0.02, eps=16 / 255)
    assert no_build == []


@pytest.mark.parametrize("case", list(ADAM_REFUSED))
def test_adam_kernel_refuses_before_any_build(no_build, case):
    """``adam_update_kernel`` raises on tensors off the card, a dtype other
    than float32, mismatched shapes and non-contiguous inputs before it
    builds, loads or launches anything; the buffers are left as they were."""
    change, exc, msg = ADAM_REFUSED[case]
    planes = {k: _planes(2, 4, 4, 3) for k in ("x", "g", "mu", "nu")}
    args = {**planes, **change}
    with pytest.raises(exc, match=msg):
        au.adam_update_kernel(**args, lr=1e-2, table=au.bias_table("cpu"),
                              step=au.step_index("cpu", 0))
    assert no_build == []
    if case != "meta":
        assert all(not t.any() for t in args.values())



# what the conv wrappers refuse, on the CPU, before they build or load a
# library: (changes to matching CPU arguments, the exception, its message)
STYLED_REFUSED = {
    "cpu": ({}, ValueError, "must be a CUDA tensor"),
    "meta": ({k: torch.empty(v, device="meta") for k, v in dict(
        x=(2, 8, 8, 32), weight=(3, 3, 32, 32), style=(2, 32), noise=(1, 8, 8, 1),
        noise_strength=(), bias=(32,)).items()}, ValueError, "must be a CUDA tensor"),
    "cin not a multiple of 16": ({"x": _planes(2, 8, 8, 24), "weight": _planes(3, 3, 24, 32),
                                  "style": _planes(2, 24)}, ValueError, "unsupported shapes"),
    "cout not a multiple of 32": ({"weight": _planes(3, 3, 32, 48), "bias": _planes(48)},
                                  ValueError, "unsupported shapes"),
    "per-sample noise": ({"noise": _planes(2, 8, 8, 1)}, ValueError, "unsupported shapes"),
    "non-contiguous x": ({"x": _strided(2, 8, 8, 32)}, ValueError, "must be contiguous"),
    "style": ({"style": _planes(2, 16)}, ValueError, "do not match x and w"),
    "bias": ({"bias": _planes(16)}, ValueError, "do not match x and w"),
}
CONV_REFUSED = {
    "cpu": ({}, ValueError, "must be on one CUDA device"),
    "channels": ({"x": _planes(1, 8, 8, 48), "w": _planes(3, 3, 48, 48)}, ValueError,
                 r"takes \(N,H,W,C\)"),
    "dtype": ({"w": _planes(3, 3, 32, 32, dtype=torch.bfloat16)}, TypeError, "dtype"),
    "non-contiguous x": ({"x": _strided(1, 8, 8, 32)}, ValueError, "contiguous"),
}
WGRAD_REFUSED = {
    "cpu": ({}, ValueError, "must be on one CUDA device"),
    "channels": ({"x": _planes(1, 8, 8, 48), "g": _planes(1, 8, 8, 48)}, ValueError,
                 r"takes \(N,H,W,C\)"),
    "shape": ({"g": _planes(1, 8, 4, 32)}, ValueError, "g must match x"),
    "non-contiguous x": ({"x": _strided(1, 8, 8, 32)}, ValueError, "contiguous"),
}


@pytest.mark.parametrize("case", list(STYLED_REFUSED))
def test_styled_conv_kernel_refuses_before_any_build(no_build, case):
    """``styled_conv_kernel`` raises on tensors off the card, a Cin that is
    not a multiple of 16, a Cout that is not a multiple of 32, a per-sample
    noise plane, a non-contiguous x and a style or bias that does not match
    before it builds, loads or launches anything."""
    change, exc, msg = STYLED_REFUSED[case]
    args = dict(x=_planes(2, 8, 8, 32), weight=_planes(3, 3, 32, 32), style=_planes(2, 32),
                noise=_planes(1, 8, 8, 1), noise_strength=_planes(), bias=_planes(32))
    with pytest.raises(exc, match=msg):
        sc.styled_conv_kernel(**{**args, **change})
    assert no_build == []


BWD_REFUSED = {
    "cpu": ({}, ValueError, "must be a CUDA tensor"),
    "float32": ({"x": _planes(2, 8, 8, 32), "g": _planes(2, 8, 8, 32)}, ValueError,
                "unsupported shapes or dtype"),
    "cin not a multiple of 32": ({"x": _planes(2, 8, 8, 16, dtype=torch.bfloat16),
                                  "weight": _planes(3, 3, 16, 32), "style": _planes(2, 16)},
                                 ValueError, "unsupported shapes"),
    "per-sample noise": ({"noise": _planes(2, 8, 8, 1)}, ValueError, "unsupported shapes"),
    "g at the wrong plane": ({"g": _planes(2, 16, 16, 32, dtype=torch.bfloat16)}, ValueError,
                             "must be a contiguous"),
    "float32 g": ({"g": _planes(2, 8, 8, 32)}, ValueError, "must be a contiguous"),
    "style": ({"style": _planes(2, 16)}, ValueError, "do not match x and w"),
}


@pytest.mark.parametrize("case", list(BWD_REFUSED))
def test_styled_conv_backward_kernel_refuses_before_any_build(no_build, case):
    """``styled_conv_backward_kernel`` raises on tensors off the card,
    float32, a Cin K2 does not take, per-sample noise, a g that does not
    match y and a style that does not match x before it builds, loads or
    launches anything."""
    change, exc, msg = BWD_REFUSED[case]
    bf16 = torch.bfloat16
    args = dict(x=_planes(2, 8, 8, 32, dtype=bf16), weight=_planes(3, 3, 32, 32),
                style=_planes(2, 32), noise=_planes(1, 8, 8, 1), noise_strength=_planes(),
                bias=_planes(32), g=_planes(2, 8, 8, 32, dtype=bf16))
    with pytest.raises(exc, match=msg):
        sc.styled_conv_backward_kernel(**{**args, **change})
    assert no_build == []


UP_REFUSED = {
    "cpu": ({}, ValueError, "must be a CUDA tensor"),
    "float32": ({"x": _planes(2, 8, 8, 32)}, ValueError, "unsupported shapes or dtype"),
    "noise at the input's plane": ({"noise": _planes(1, 8, 8, 1)}, ValueError,
                                   "unsupported shapes"),
    "per-sample noise": ({"noise": _planes(2, 16, 16, 1)}, ValueError, "unsupported shapes"),
    "non-contiguous x": ({"x": _strided(2, 8, 8, 32).bfloat16()}, ValueError,
                         "must be contiguous"),
    "style": ({"style": _planes(2, 16)}, ValueError, "do not match x and w"),
}


@pytest.mark.parametrize("case", list(UP_REFUSED))
def test_styled_conv_up_kernel_refuses_before_any_build(no_build, case):
    """``styled_conv_up_kernel`` raises on tensors off the card, float32, a
    noise plane not at the output's size or per sample, a non-contiguous x
    and a style that does not match, before it builds, loads or launches
    anything."""
    change, exc, msg = UP_REFUSED[case]
    args = dict(x=_planes(2, 8, 8, 32, dtype=torch.bfloat16), weight=_planes(3, 3, 32, 32),
                style=_planes(2, 32), noise=_planes(1, 16, 16, 1), noise_strength=_planes(),
                bias=_planes(32))
    with pytest.raises(exc, match=msg):
        sc.styled_conv_up_kernel(**{**args, **change})
    assert no_build == []


@pytest.mark.parametrize("case", list(CONV_REFUSED))
@pytest.mark.parametrize("kernel", ["forward", "input_grad"])
def test_conv3x3_kernel_refuses_before_any_build(no_build, kernel, case):
    """The conv3x3 forward and input-grad wrappers raise on tensors off the
    card, channels the kernels do not take, mismatched dtypes and a
    non-contiguous x before they build, load or launch anything."""
    change, exc, msg = CONV_REFUSED[case]
    args = {**dict(x=_planes(1, 8, 8, 32), w=_planes(3, 3, 32, 32)), **change}
    fn = {"forward": c3.conv3x3_forward_kernel, "input_grad": c3.conv3x3_input_grad_kernel}
    with pytest.raises(exc, match=msg):
        fn[kernel](args["x"], args["w"])
    assert no_build == []


@pytest.mark.parametrize("case", list(WGRAD_REFUSED))
def test_conv3x3_weight_grad_kernel_refuses_before_any_build(no_build, case):
    """The weight-grad wrapper raises on tensors off the card, channels the
    kernel does not take, a g that does not match x and a non-contiguous x
    before it builds, loads or launches anything."""
    change, exc, msg = WGRAD_REFUSED[case]
    args = {**dict(x=_planes(1, 8, 8, 32), g=_planes(1, 8, 8, 32)), **change}
    with pytest.raises(exc, match=msg):
        c3.conv3x3_weight_grad_kernel(args["x"], args["g"])
    assert no_build == []


def _header_classes():
    """``{name: (code, WgTile arguments)}`` from csrc/conv3x3_wgmma.cuh: the
    ``using Wg<Name> = WgTile<...>`` lines and the cases of ``with_class``,
    which every bf16 conv launch goes through."""
    import re
    text = (_lib.CSRC / "conv3x3_wgmma.cuh").read_text()
    tiles = {m.group(1).lower(): tuple(int(a) if a.strip().lstrip("-").isdigit()
                                       else a.strip() == "true" for a in m.group(2).split(","))
             for m in re.finditer(r"using Wg(\w+) = WgTile<([^>]*)>;", text)}
    codes = {m.group(2).lower(): int(m.group(1))
             for m in re.finditer(r"case (\d+):\s*return f\(Wg(\w+)\{\}\)", text)}
    return {name: (codes[name], args) for name, args in tiles.items()}


def test_mma_classes_mirror_the_header():
    """``MMA_CLASSES`` holds the header's tile classes, field for field, under
    the codes ``with_class`` switches on."""
    header = _header_classes()
    assert set(header) == {cls.name for cls in c3.MMA_CLASSES}
    for cls in c3.MMA_CLASSES:
        code, args = header[cls.name]
        assert code == cls.code
        assert args == (cls.th, cls.tw, cls.wgs, cls.team_wgs, cls.mt, cls.bn, cls.ck,
                        cls.stages, cls.resident, cls.min_blocks)
        assert cls.smem_bytes(64) <= c3.MMA_SMEM_MAX



def test_wgrad_classes_mirror_the_header():
    """``WGRAD_CLASSES`` holds the bf16 weight grad's tile classes
    (``using Wgrad<C> = WgradTile<C, TH, STAGES>`` in csrc/conv3x3_wgrad.cuh)
    field for field, each under the channel count ``tf_conv3x3_wgrad``
    dispatches to it, and each ring fits a block's shared memory."""
    import re
    header = (_lib.CSRC / "conv3x3_wgrad.cuh").read_text()
    tiles = {int(m.group(1)): tuple(int(a) for a in m.group(2).split(","))
             for m in re.finditer(r"using Wgrad(\d+) = WgradTile<([^>]*)>;", header)}
    entry = (_lib.CSRC / "conv3x3.cu").read_text()
    dispatch = {int(c): int(name) for c, name in re.findall(
        r"if \(C == (\d+)\) return tf::launch_wgrad_wgmma<tf::Wgrad(\d+)>", entry)}
    assert set(tiles) == set(c3.WGRAD_CLASSES) == set(c3.CHANNELS)
    assert dispatch == {c: c for c in c3.CHANNELS}
    for c, cls in c3.WGRAD_CLASSES.items():
        assert tiles[c] == (cls.c, cls.th, cls.stages) and cls.name == f"wgrad{c}"
        assert cls.smem_bytes() <= c3.MMA_SMEM_MAX


def test_phase3_wgrad_ragged_cases_reach_every_class_and_tile_edge():
    """``chip_smoke.py`` phase 3's weight-grad cases put each tile class on
    planes whose height and width are not multiples of its tile, both on a
    plane of several tiles each way and on one smaller than a tile (the
    TMA boxes mostly outside the tensor), and on a batch whose tiles run
    across images; a single pixel is among them (8 of 9 taps read only
    padding)."""
    smoke = _chip_smoke()
    for c, cls in c3.WGRAD_CLASSES.items():
        mine = [(n, h, w) for n, h, w, ch in smoke.WGRAD_RAGGED if ch == c]
        assert any(h % cls.th and w % cls.tw and h > cls.th and w > cls.tw
                   for _, h, w in mine), cls.name
        assert any(h < cls.th or w < cls.tw for _, h, w in mine), cls.name
        assert any(n > 1 and (h % cls.th or w % cls.tw) for n, h, w in mine), cls.name
    assert (1, 1, 1, 32) in smoke.WGRAD_RAGGED

# the class of every styled_conv plane on the main paths (PERF.md section 6):
# FFHQ's synthesis at batch 1 (PGD), 5 (white-box) and 6 (the partial
# evaluation), car's at 4 and church's at 3; conv3x3's planes
MAIN_PATH_CLASSES = {
    1: ("small", "small", "small", "small", "mid", "wide", "wide", "narrow64", "narrow32"),
    5: ("small", "small", "mid", "wide", "wide", "wide", "wide", "narrow64", "narrow32"),
    6: ("small", "small", "mid", "wide", "wide", "wide", "wide", "narrow64", "narrow32"),
    4: ("small", "small", "small", "mid", "wide", "wide", "wide", "narrow64"),
    3: ("small", "small", "small", "mid", "wide", "wide", "wide"),
}
SYNTHESIS = ((4, 512), (8, 512), (16, 512), (32, 512), (64, 512), (128, 256), (256, 128),
             (512, 64), (1024, 32))


@pytest.mark.parametrize("batch", list(MAIN_PATH_CLASSES))
def test_main_path_planes_get_their_class(batch):
    got = tuple(c3.mma_class(batch, res, res, ch, ch).name
                for res, ch in SYNTHESIS[:len(MAIN_PATH_CLASSES[batch])])
    assert got == MAIN_PATH_CLASSES[batch]
    for n, res, ch in ((1, 1024, 32), (5, 1024, 32), (1, 512, 64), (4, 512, 64), (5, 512, 64)):
        assert c3.mma_class(n, res, res, ch, ch).name == f"narrow{ch}"


def _chip_smoke():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase3_ragged_cases_reach_every_class_and_box_edge():
    """``chip_smoke.py`` phase 3's ragged cases put every tile class on a
    plane whose height and width are not multiples of its tile, reach a
    plane of 1-3 pixels a side, a partial channel chunk in every class
    whose chunk is wider than 16, Cout 96, and a view 2 bytes off."""
    smoke = _chip_smoke()
    cases = list(smoke.STYLED_RAGGED) + [(n, h, w, c, c) for n, h, w, c in smoke.CONV_RAGGED]
    picked = [(c3.mma_class(*case), case) for case in cases]
    assert {cls.name for cls, _ in picked} == {cls.name for cls in c3.MMA_CLASSES}
    for cls in c3.MMA_CLASSES:
        mine = [case for got, case in picked if got == cls]
        assert any(h % cls.th for _, h, _, _, _ in mine), cls.name
        assert any(w % cls.tw for _, _, w, _, _ in mine), cls.name
        if cls.ck > 16:
            assert any(cin % cls.ck for _, _, _, cin, _ in mine), cls.name
    assert any(min(h, w) <= 3 for _, h, w, _, _ in cases)
    assert any(cout == 96 for *_, cout in cases)
    assert smoke.VIEW_OFF["styled"] in smoke.STYLED_RAGGED
    assert smoke.VIEW_OFF["conv"] in smoke.CONV_RAGGED


def test_phase3_up_cases_reach_every_class_and_phase_edge():
    """``chip_smoke.py`` phase 3's styled_conv_up cases put the phase conv
    (Cin -> 4 Cout) in every tile class, on planes whose height and width
    are not multiples of the class's tile, and on a Cout below a block's
    channels (a block then holds several phases); every case is one the
    kernel takes."""
    smoke = _chip_smoke()
    cases = [(n, h, h, cin, cout) for n, (_, top) in smoke.UP_BATCHES.items()
             for h, cin, cout in smoke.UP_SHAPES if 2 * h <= top] + list(smoke.UP_RAGGED)
    picked = [(c3.mma_class(n, h, w, cin, 4 * cout), (n, h, w, cin, cout))
              for n, h, w, cin, cout in cases]
    assert {cls.name for cls, _ in picked} == {cls.name for cls in c3.MMA_CLASSES}
    for cls in c3.MMA_CLASSES:
        mine = [case for got, case in picked if got == cls]
        assert any(h % cls.th or w % cls.tw for _, h, w, _, _ in mine), cls.name
    assert any(cout < cls.bn for cls, (*_, cout) in picked)
    assert any(cout % 32 for *_, cout in cases)
    assert all(sc.up_supported((n, h, w, cin), (3, 3, cin, cout), (1, 2 * h, 2 * w, 1),
                               torch.bfloat16) for n, h, w, cin, cout in cases)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cls,cin,cout", [(c3.NARROW32, 48, 32), (c3.NARROW64, 64, 64),
                                          (c3.WIDE, 32, 256), (c3.SMALL, 48, 96)])
def test_pack_mma_weights_is_the_descriptor_layout(dtype, cls, cin, cout):
    """The packed weights are one contiguous buffer in which element (n, k)
    of the B block of (Cout slice, chunk, tap, k-step) sits where the
    kernel's wgmma descriptor reads it (K-major, no swizzle: 8 x 8 core
    matrices of 128 bytes, ``16 * BN`` bytes between the two along K), and
    input channels past Cin are zero; also from weights already in bf16."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3, 3, cin, cout, generator=g).to(dtype)
    packed = c3.pack_mma_weights(w, cls)
    assert packed.is_contiguous() and packed.dtype == torch.bfloat16
    flat = packed.reshape(-1)
    ks_n, chunks = cls.ck // 16, cls.chunks(cin)
    n = torch.arange(cls.bn).view(1, -1)
    k = torch.arange(16).view(-1, 1)
    byte = (n % 8) * 16 + (n // 8) * 128 + (k % 8) * 2 + (k // 8) * 16 * cls.bn
    for slice_ in range(cout // cls.bn):
        for chunk in range(chunks):
            for tap in range(9):
                for ks in range(ks_n):
                    start = (((slice_ * chunks + chunk) * 9 + tap) * ks_n + ks) * 16 * cls.bn
                    block = flat[start + byte // 2].float()
                    ci = chunk * cls.ck + ks * 16 + k.view(-1)
                    want = torch.zeros(16, cls.bn)
                    inside = ci < cin
                    want[inside] = w[tap // 3, tap % 3, ci[inside],
                                     slice_ * cls.bn:(slice_ + 1) * cls.bn].bfloat16().float()
                    assert torch.equal(block, want)

"""Parity of the port's baselines, hybrid splice, imaging helpers, PRNG pool
and ``white_box_patch`` with the JAX package.

- ``resize_bilinear`` down and up against ``jax.image.resize`` (1e-6; the
  antialiased shrink is the function that ``paste_patch`` needs), and its
  gradient, two matrix products with the weights read off the identity,
  against PyTorch's own backward and JAX's (1e-6 of the largest entry:
  float32 sums of the same terms in another order);
- the separable blur against JAX's 2-D blur at k in {3, 5, 13} and an
  explicit sigma (1e-6), and the even-k error;
- ``dp_noise`` with JAX's uniform draw supplied (1e-6), and its statistics;
- ``paste_patch`` (1e-6, the resize's) and the out-of-domain inputs
  (exact); ``splice_hybrid`` counts, rows and errors;
- ``to_uint8``, ``from_uint8``, ``montage``, ``grid_montage`` exact;
  ``PRNGPool`` determinism;
- ``white_box_patch`` (per-image paste targets into ``run_whitebox``)
  against JAX for 2 iterations, with the bounds of
  ``tests/test_torch_whitebox.py``: traces to atol = rtol = 2e-4; where the
  first step's |g| > 1e-6, pixels to 0.2 lr and their mean to 1e-5, the
  batch-mean run's bounds there, and all but 0.1% of them to 0.02 lr, the
  per-image run's (one pixel of 6,137 reads 0.030 lr: Adam's second step
  carries the packages' leaky-ReLU-kink gradient differences, as that
  module's docstring explains).
CPU, float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread, port_of  # noqa: F401
from tpufusion.attacks import baselines as jbl
from tpufusion.attacks import whitebox as jwb
from tpufusion.attacks.hybrid import splice_hybrid as j_splice
from tpufusion.core import imaging as jim
from tpufusion.core import prng as jprng
from tpufusion.pipeline import create_test_pipeline
from tpufusion_torch.attacks import baselines as bl
from tpufusion_torch.attacks import whitebox as wb
from tpufusion_torch.attacks.hybrid import splice_hybrid
from tpufusion_torch.core import imaging as im
from tpufusion_torch.core import prng

LR = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, shape=(2, 32, 32, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("src,dst", [(32, 10), (32, 21), (64, 21), (10, 32), (21, 64), (32, 32)])
def test_resize_bilinear_matches_jax(src, dst):
    x = _images(1, (2, src, src, 3))
    got = im.resize_bilinear(_t(x), dst, dst)
    want = jim.resize_bilinear(jnp.asarray(x), dst, dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    rect = im.resize_bilinear(_t(x), dst, src)
    np.testing.assert_allclose(rect.numpy(), np.asarray(jim.resize_bilinear(jnp.asarray(x),
                                                                            dst, src)),
                               rtol=0, atol=1e-6)
    assert im.resize_bilinear(_t(x).bfloat16(), dst, dst).dtype == torch.bfloat16


@pytest.mark.parametrize("src,dst,dst_w", [(64, 16, 16), (32, 10, 21), (10, 32, 32),
                                            (32, 32, 32), (48, 24, 7)])
def test_resize_bilinear_gradient(src, dst, dst_w):
    x = _images(2, (2, src, src, 3))
    g = _images(3, (2, dst, dst_w, 3))
    xt = _t(x).requires_grad_()
    (im.resize_bilinear(xt, dst, dst_w) * _t(g)).sum().backward()
    xp = _t(x).requires_grad_()
    y = torch.nn.functional.interpolate(xp.permute(0, 3, 1, 2), size=(dst, dst_w),
                                        mode="bilinear", align_corners=False, antialias=True)
    (y.permute(0, 2, 3, 1) * _t(g)).sum().backward()
    _, vjp = jax.vjp(lambda a: jim.resize_bilinear(a, dst, dst_w), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    scale = np.abs(want).max()
    np.testing.assert_allclose(xt.grad.numpy(), xp.grad.numpy(), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1e-6 * scale)
    rows = im.resize_weights(src, dst_w, "cpu")
    assert rows.shape == (dst_w, src) and rows is im.resize_weights(src, dst_w, "cpu")
    np.testing.assert_allclose(rows.sum(1).numpy(), 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,sigma", [(3, 0.0), (5, 0.0), (13, 0.0), (5, 0.5), (5, 3.0)])
def test_blur_matches_jax_2d(k, sigma):
    """Two 1-D passes against JAX's one 2-D ``outer(k1, k1)`` convolution:
    the same sums in another order, so float32 rounding apart (1e-6)."""
    x = _images(2)
    got = bl.gaussian_blur_noise(_t(x), k, sigma)
    want = jbl.gaussian_blur_noise(jnp.asarray(x), k, sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert got.dtype == torch.float32


def test_blur_kernel_must_be_odd():
    with pytest.raises(ValueError, match="odd"):
        bl.gaussian_blur_noise(torch.zeros(1, 16, 16, 3), 4)
    assert bl.gaussian_blur_noise(torch.zeros(1, 16, 16, 3).bfloat16(), 3).dtype == torch.bfloat16


def test_dp_noise_matches_jax_with_its_draw():
    """JAX's draw, computed from the key as ``jax.random.laplace`` does:
    ``u`` uniform in [-1 + epsneg, 1), noise ``sign(u) * log1p(-|u|)``."""
    x = _images(3)
    key = jax.random.key(4)
    eps = float(jnp.finfo(jnp.float32).epsneg)
    u = jax.random.uniform(key, x.shape, jnp.float32, minval=-1.0 + eps, maxval=1.0)
    np.testing.assert_allclose(bl.laplace_from_uniform(_t(u)).numpy(),
                               np.asarray(jax.random.laplace(key, x.shape, jnp.float32)),
                               rtol=0, atol=1e-6)
    got = bl.dp_noise(_t(x), scale=0.4, uniform=_t(u))
    want = jbl.dp_noise(jnp.asarray(x), key, 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_dp_noise_statistics():
    """Laplace(b): E|X| = b and median |X| = b ln 2; over 49,152 draws the
    mean's standard error is b / 222, the limit 2% of b is 4.4 of them."""
    x = torch.zeros(4, 64, 64, 3)
    g = torch.Generator().manual_seed(5)
    noise = bl.dp_noise(x, g, 0.4)
    assert abs(noise.abs().mean().item() - 0.4) <= 0.02 * 0.4
    assert abs(noise.abs().median().item() - 0.4 * np.log(2)) <= 0.03 * 0.4
    assert abs((noise > 0).float().mean().item() - 0.5) <= 0.01
    assert torch.equal(noise, bl.dp_noise(x, torch.Generator().manual_seed(5), 0.4))


def test_paste_and_out_domain_match_jax():
    x = _images(6, (3, 30, 30, 3))
    t = _images(7, (1, 30, 30, 3))
    got = bl.paste_patch(_t(x), _t(t), 3)
    want = np.asarray(jbl.paste_patch(jnp.asarray(x), jnp.asarray(t), 3))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    outside = np.ones(x.shape, bool)
    outside[:, 10:20, 10:20] = False
    np.testing.assert_array_equal(got.numpy()[outside], x[outside])
    np.testing.assert_array_equal(bl.out_domain_more(_t(x), _t(t)).numpy(),
                                  np.asarray(jbl.out_domain_more(jnp.asarray(x), jnp.asarray(t))))
    for i in range(3):
        np.testing.assert_array_equal(
            bl.out_domain_single(_t(x), _t(t), i).numpy(),
            np.asarray(jbl.out_domain_single(jnp.asarray(x), jnp.asarray(t), i)))


@pytest.mark.parametrize("n_sources,n_slots", [(1, 5), (2, 5), (3, 5), (3, 7), (4, 4)])
def test_splice_hybrid_matches_jax(n_sources, n_slots):
    batches = [_images(10 + i, (n_slots, 4, 4, 3)) for i in range(n_sources)]
    got, counts = splice_hybrid([_t(b) for b in batches], n_slots)
    want, j_counts = j_splice([jnp.asarray(b) for b in batches], n_slots)
    assert counts == j_counts and sum(counts) == n_slots
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_splice_hybrid_errors():
    with pytest.raises(ValueError, match="at least one"):
        splice_hybrid([], 5)
    with pytest.raises(ValueError, match="cannot cover"):
        splice_hybrid([torch.zeros(5, 2), torch.zeros(2, 2)], 5)


def test_imaging_helpers_match_jax():
    x = _images(8, (3, 6, 5, 3)) * 1.2
    np.testing.assert_array_equal(im.to_uint8(_t(x)), jim.to_uint8(x))
    u8 = im.to_uint8(x)
    np.testing.assert_array_equal(im.from_uint8(u8), jim.from_uint8(u8))
    for args in ((), (0,), (3, 0.5)):
        np.testing.assert_array_equal(im.montage(_t(x), *args), jim.montage(x, *args))
        np.testing.assert_array_equal(im.montage(_t(x[0]), *args), jim.montage(x[0], *args))
    for nrow in (1, 2, 8):
        np.testing.assert_array_equal(im.grid_montage(_t(x), nrow),
                                      jim.grid_montage(x, nrow))


def test_prng_pool_is_deterministic():
    assert prng.GLOBAL_SEED == jprng.GLOBAL_SEED == 123456789

    def draws(pool, n):
        return [torch.rand(3, generator=g).tolist() for g in pool.next_n(n)]

    a = prng.PRNGPool(7, device="cpu")
    b = prng.PRNGPool(7, device="cpu")
    first = draws(a, 3)
    assert first == draws(b, 3)
    assert len({tuple(d) for d in first}) == 3
    assert draws(a, 1) == [torch.rand(3, generator=b.next()).tolist()]
    assert first != draws(prng.PRNGPool(8, device="cpu"), 3)
    pool = prng.seed_everything(7, device="cpu")
    assert draws(pool, 3) == first
    assert pool.device.type == "cpu"


@pytest.fixture(scope="module")
def pipelines():
    jp = create_test_pipeline("ffhq", jax.random.key(0), size=32)
    rng = np.random.default_rng(41)
    imgs = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    return jp, port_of(jp), imgs, target


def test_white_box_patch_matches_jax(pipelines):
    """`runner.py:292-294`: each image's target is the image with the
    resized target pasted in its centre."""
    jp, tp, imgs, target = pipelines
    j_targets = jbl.paste_patch(jnp.asarray(imgs), jnp.asarray(target), 3)
    targets = bl.paste_patch(_t(imgs), _t(target), 3)
    np.testing.assert_allclose(targets.numpy(), np.asarray(j_targets), rtol=0, atol=1e-6)
    jcfg = jwb.WhiteboxConfig(lr=LR, n_iters=2, execution="stepwise")
    j_adv, j_trace = jwb.run_whitebox(jp, jnp.asarray(imgs), j_targets, jcfg)
    adv, trace = wb.run_whitebox(tp, _t(imgs), targets, wb.WhiteboxConfig(lr=LR, n_iters=2))
    for k, v in trace.items():
        assert tuple(v.shape) == (2, 2) == np.shape(j_trace[k]), k
        np.testing.assert_allclose(v.numpy(), np.asarray(j_trace[k]), atol=2e-4, rtol=2e-4,
                                   err_msg=k)
    ref = wb._make_ref(tp)(_t(imgs), targets)
    x = _t(imgs).requires_grad_(True)
    total, _ = wb._make_loss(tp, wb.PRESET_ATTACK_MAIN, per_image=True)(x, ref)
    mask = np.abs(torch.autograd.grad(total.sum(), x)[0].numpy()) > 1e-6
    assert mask.mean() > 0.5
    err = np.abs(adv.numpy() - np.asarray(j_adv))[mask]
    assert err.max() <= 0.2 * LR and err.mean() <= 1e-5, (err.max(), err.mean())
    assert (err > 0.02 * LR).mean() <= 1e-3, (err > 0.02 * LR).sum()
    assert (adv - _t(imgs)).abs().max() > 0.5 * LR

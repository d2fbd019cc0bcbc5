"""Parity of the port's patch attack with the JAX package, on the 32^2 test
pipeline (``tpufusion.pipeline.create_test_pipeline``) whose weights are
carried into the port.

- sizes, initial patches and their errors;
- the square transform bit-exact against JAX's, every quarter turn, with
  JAX's draw (computed from its key as ``square_transform`` does) passed in;
- the circle transform to 1e-6 where the two packages' float32 cosine and
  sine of the angle agree, and to 2^-12 at a 366-pixel side where they
  differ by an ulp (the bound is derived in
  ``test_circle_transform_matches_jax``);
- ``masked_composite`` and ``apply_patch`` exact, ``extract_patch``,
  ``submatrix``, ``canonical_canvas`` for both patch types;
- the patch step at ``max_count`` 2, without and with the target terms
  (decoder and VGG taps in the loss): loss traces to rtol 1e-4, the
  patch's move, the sum of 2 raw gradients, to 1e-3 of its largest entry
  (the gradient bound of ``tests/test_torch_whitebox.py``);
- ``train_patch`` over 2 images with JAX's initial patch and draws, and a
  JAX-trained (canvas, mask) applied by the port equals JAX's result.
CPU, float32.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread, port_of  # noqa: F401
from tpufusion.attacks import patch as jpa
from tpufusion.ops.composite import masked_composite as j_composite
from tpufusion.pipeline import create_test_pipeline
from tpufusion_torch.attacks import patch as tpa
from tpufusion_torch.ops.composite import masked_composite

S = 32


@pytest.fixture(scope="module")
def pipelines():
    jp = create_test_pipeline("ffhq", jax.random.key(0), size=S)
    rng = np.random.default_rng(31)
    imgs = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    return jp, port_of(jp), imgs, target


def _t(a):
    return torch.from_numpy(np.array(a))


def _square_draw(key, size, side):
    """JAX's square_transform draw from ``key`` (`patch.py:115-122`)."""
    krot, kloc = jax.random.split(key)
    k = int(jax.random.randint(krot, (), 0, 4))
    pos = jax.random.randint(kloc, (2,), 0, size - side + 1)
    return k, tuple(int(v) for v in np.asarray(pos))


def _circle_draw(key, size, side):
    """JAX's circle_transform draw from ``key`` (`patch.py:133-137`)."""
    krot, kloc = jax.random.split(key)
    angle = jax.random.uniform(krot, (), minval=0.0, maxval=2 * math.pi)
    pos = jax.random.randint(kloc, (2,), 0, size - side + 1)
    return float(angle), tuple(int(v) for v in np.asarray(pos))


def test_sizes_and_errors():
    g = torch.Generator().manual_seed(0)
    for size, frac in ((32, 0.1), (1024, 0.1), (256, 0.05), (64, 1.0)):
        assert tpa.patch_side(size, frac) == jpa.patch_side(size, frac)
        sq = tpa.init_patch_square(size, frac, g)
        assert sq.shape == (jpa.patch_side(size, frac),) * 2 + (3,)
        assert sq.dtype == torch.float32 and -1 <= sq.min() and sq.max() < 1
    assert tpa.init_patch_square(1024, 0.1, g).shape[0] == 324
    for size, frac, side in ((32, 0.1, 12), (1024, 0.1, 366), (128, 0.5, 102)):
        ci = tpa.init_patch_circle(size, frac, g)
        assert ci.shape == (side, side, 3)
        np.testing.assert_array_equal(tpa._circle_mask(side).numpy(),
                                      np.asarray(jpa._circle_mask(side)))
        assert (ci * (1 - tpa._circle_mask(side)) == 0).all()
    assert jpa.init_patch_circle(32, 0.1, jax.random.key(0)).shape == (12, 12, 3)
    with pytest.raises(ValueError, match="patch_frac must be <= 1"):
        tpa.init_patch_square(32, 1.5, g)
    with pytest.raises(ValueError, match="pi/4"):
        tpa.init_patch_circle(32, 0.9, g)
    with pytest.raises(ValueError, match="pi/4"):
        jpa.init_patch_circle(32, 0.9, jax.random.key(0))
    with pytest.raises(ValueError, match="leaves"):
        tpa.square_transform(sq[:4, :4], 32, draw=(0, (29, 0)))
    assert dataclasses.asdict(tpa.PatchConfig()) == dataclasses.asdict(jpa.PatchConfig())


def test_square_transform_matches_jax():
    patch = jpa.init_patch_square(S, 0.1, jax.random.key(3))
    side = patch.shape[0]
    seen = set()
    for i in range(40):
        key = jax.random.key(100 + i)
        k, pos = _square_draw(key, S, side)
        canvas, mask, jpos = jpa.square_transform(patch, S, key)
        got = tpa.square_transform(_t(patch), S, draw=(k, pos))
        assert got[2] == pos == tuple(np.asarray(jpos).tolist())
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(canvas))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(mask))
        seen.add(k)
        if len(seen) == 4:
            break
    assert seen == {0, 1, 2, 3}


def test_transforms_draw_from_a_generator():
    """With a generator the placement and the rotation come from it: the
    canvas is one of the four turns of the patch at the returned corner,
    and the same seed gives the same draw."""
    patch = tpa.init_patch_square(S, 0.1, torch.Generator().manual_seed(1))
    side = patch.shape[0]
    canvas, mask, (y, x) = tpa.square_transform(patch, S, torch.Generator().manual_seed(2))
    again = tpa.square_transform(patch, S, torch.Generator().manual_seed(2))
    assert torch.equal(canvas, again[0]) and (y, x) == again[2]
    crop = canvas[y : y + side, x : x + side]
    assert any(torch.equal(crop, torch.rot90(patch, k, dims=(0, 1))) for k in range(4))
    assert mask.sum() == 3 * side * side and mask[y : y + side, x : x + side].all()
    circ = tpa.init_patch_circle(S, 0.1, torch.Generator().manual_seed(1))
    canvas, mask, (y, x) = tpa.circle_transform(circ, S, torch.Generator().manual_seed(3))
    assert (canvas * (1 - mask) == 0).all() and 0 <= y <= S - circ.shape[0]


@pytest.mark.parametrize("size,frac", [(S, 0.1), (1024, 0.1)])
def test_circle_transform_matches_jax(size, frac):
    """The port samples in pixel coordinates as ``map_coordinates`` does:
    where both packages' float32 cos and sin of the angle agree, the canvas
    agrees to 1e-6. Where XLA's cos or sin is an ulp off the correctly
    rounded value the port uses (key 236 here; 131 of 5,000 angles), each
    sample coordinate moves by up to side * 2^-24 (an ulp of each of the two
    terms, at radius side / 2) plus an ulp of the coordinate itself (2^-15
    below 512), and the bilinear value by at most 2 (the largest neighbour
    difference) per pixel of move along each axis: at side 366 that is
    2 * 2 * (2.2e-5 + 3.1e-5) = 2.1e-4, held to 2^-12 (2.4e-4); key 236
    reads 7.2e-5."""
    patch = jpa.init_patch_circle(size, frac, jax.random.key(5))
    side = patch.shape[0]
    agreed = 0
    for i in list(range(12)) + [36]:
        key = jax.random.key(200 + i)
        angle, pos = _circle_draw(key, size, side)
        canvas, mask, jpos = jpa.circle_transform(patch, size, key)
        got = tpa.circle_transform(_t(patch), size, draw=(angle, pos))
        assert got[2] == pos == tuple(np.asarray(jpos).tolist())
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(mask))
        a = np.float32(angle)
        same = (np.float32(jnp.cos(a)) == np.float32(np.cos(np.float64(a)))
                and np.float32(jnp.sin(a)) == np.float32(np.sin(np.float64(a))))
        agreed += same
        tol = 1e-6 if same else 2.0 ** -12
        np.testing.assert_allclose(got[0].numpy(), np.asarray(canvas), rtol=0, atol=tol,
                                   err_msg=f"angle {angle}, cos/sin agree: {same}")
    assert 6 <= agreed < 13


def test_composite_and_apply_patch_exact(pipelines):
    _, _, imgs, _ = pipelines
    patch = jpa.init_patch_square(S, 0.1, jax.random.key(4))
    canvas, mask, _ = jpa.square_transform(patch, S, jax.random.key(6))
    got = masked_composite(_t(imgs[0]), _t(canvas), _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_composite(imgs[0], canvas, mask)))
    got = masked_composite(_t(imgs[0]), _t(canvas) * 3, _t(mask), -0.5, 0.25)
    want = j_composite(imgs[0], canvas * 3, mask, -0.5, 0.25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpa.apply_patch(_t(imgs), _t(canvas), _t(mask)).numpy(),
        np.asarray(jpa.apply_patch(jnp.asarray(imgs), canvas, mask)))
    side = patch.shape[0]
    _, _, pos = jpa.square_transform(patch, S, jax.random.key(6))
    np.testing.assert_array_equal(
        tpa.extract_patch(_t(canvas), tuple(np.asarray(pos).tolist()), side).numpy(),
        np.asarray(jpa.extract_patch(canvas, pos, side)))
    m = np.zeros((8, 8))
    m[2:5, 3:7] = 1.0
    assert tpa.submatrix(m).shape == jpa.submatrix(m).shape == (3, 4)
    assert tpa.submatrix(np.zeros((4, 4))).shape == (0, 0)


@pytest.mark.parametrize("patch_type", ["square", "circle"])
def test_canonical_canvas_matches_jax(patch_type):
    init = jpa.init_patch_square if patch_type == "square" else jpa.init_patch_circle
    patch = init(S, 0.2, jax.random.key(8))
    got = tpa.canonical_canvas(_t(patch), S, patch_type)
    want = jpa.canonical_canvas(patch, S, patch_type)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


REC = dict(w_latent_target=10.0, w_img_rec_target=1.0, w_lpips_rec_target=0.1)


@pytest.mark.parametrize("weights", [{}, REC], ids=["default", "target_terms"])
def test_patch_step_matches_jax(pipelines, weights):
    jp, tp, imgs, target = pipelines
    cfg = dict(max_count=2, **weights)
    patch = jpa.init_patch_square(S, 0.1, jax.random.key(9))
    key = jax.random.key(10)
    j_patch, j_trace = jpa.make_patch_attack_step(jp, jpa.PatchConfig(**cfg), jnp.asarray(target))(
        jnp.asarray(imgs[:1]), patch, key)
    step = tpa.make_patch_attack_step(tp, tpa.PatchConfig(**cfg), _t(target))
    new, trace = step(_t(imgs[:1]), _t(patch), draw=_square_draw(key, S, patch.shape[0]))
    assert trace.shape == (2,)
    np.testing.assert_allclose(trace.numpy(), np.asarray(j_trace), rtol=1e-4, atol=0)
    j_move = np.asarray(j_patch) - np.asarray(patch)
    move = new.numpy() - np.asarray(patch)
    assert np.abs(j_move).max() > 0
    np.testing.assert_allclose(move, j_move, rtol=0, atol=1e-3 * np.abs(j_move).max())


@pytest.fixture(scope="module")
def trained(pipelines):
    """``train_patch`` over 2 images (max_count 2) by both packages: the port
    gets JAX's initial patch and per-batch draws, computed from the key as
    ``train_patch`` splits it."""
    jp, tp, imgs, _ = pipelines
    key = jax.random.key(11)
    jcfg = jpa.PatchConfig(max_count=2)
    j_logs, logs = [], []
    j_out = jpa.train_patch(jp, [jnp.asarray(imgs[i : i + 1]) for i in range(2)], key, jcfg,
                            log_fn=lambda e, i, tr: j_logs.append(tr))
    key, kinit = jax.random.split(key)
    init = jpa.init_patch_square(S, jcfg.patch_frac, kinit)
    draws = []
    for _ in range(2):
        key, k = jax.random.split(key)
        draws.append(_square_draw(k, S, init.shape[0]))
    out = tpa.train_patch(tp, [_t(imgs[i : i + 1]) for i in range(2)], None,
                          tpa.PatchConfig(max_count=2), log_fn=lambda e, i, tr: logs.append(tr),
                          init_patch=_t(init), draws=draws)
    return j_out, out, j_logs, logs, np.asarray(init)


def test_train_patch_matches_jax(trained):
    (j_canvas, j_mask), (canvas, mask), j_logs, logs, init = trained
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert len(logs) == len(j_logs) == 2
    for tr, j_tr in zip(logs, j_logs):
        np.testing.assert_allclose(tr, j_tr, rtol=1e-4, atol=0)
    side = init.shape[0]
    lo = (S - side) // 2
    j_patch = np.asarray(j_canvas)[lo : lo + side, lo : lo + side]
    j_move = j_patch - init
    np.testing.assert_allclose(canvas.numpy()[lo : lo + side, lo : lo + side] - init, j_move,
                               rtol=0, atol=1e-3 * np.abs(j_move).max())
    assert (canvas.numpy()[np.asarray(j_mask) == 0] == 0).all()


def test_port_applies_a_jax_trained_patch(pipelines, trained):
    _, _, imgs, _ = pipelines
    (j_canvas, j_mask), _, _, _, _ = trained
    np.testing.assert_array_equal(
        tpa.apply_patch(_t(imgs), _t(j_canvas), _t(j_mask)).numpy(),
        np.asarray(jpa.apply_patch(jnp.asarray(imgs), j_canvas, j_mask)))


def test_epochs_reiterate_a_one_shot_iterable(pipelines):
    """``epochs`` > 1 re-runs the images, also from a generator expression;
    the generator's draws then come in order (2 epochs x 1 image)."""
    _, tp, imgs, _ = pipelines
    cfg = tpa.PatchConfig(max_count=1, epochs=2)
    logs = []
    tpa.train_patch(tp, (_t(imgs[i : i + 1]) for i in range(1)),
                    torch.Generator().manual_seed(0), cfg,
                    log_fn=lambda e, i, tr: logs.append((e, i)))
    assert logs == [(0, 0), (1, 0)]

"""The port's landmark net and FFHQ alignment against the JAX package's, CPU,
float32 (``tpufusion_torch/models/landmarks.py``,
``tpufusion_torch/data/alignment.py``).

- the forward on the packaged weights and on a width-8 random net, JAX's
  variables carried over by ``io.convert.landmark_state_from_jax``: 2e-4;
- the flip-TTA provider's pixel coordinates to 1e-3 px (so the ``1 - x``
  un-mirror and its bias are JAX's);
- ``synth_face_batch`` bit-identical; training on 32^2 faces lowers the loss
  to a fifth, as the JAX test asserts;
- the save / load and sidecar rules, across the packages too;
- ``align_face`` bit-identical given the same landmarks; provider plus
  alignment within one 8-bit level.
"""

import filecmp
import json
import os

import jax
import numpy as np
import PIL.Image
import pytest
import torch

from tests.torch_pipelines import np_tree, one_torch_thread  # noqa: F401
from tpufusion.core.dtypes import Policy as JPolicy
from tpufusion.data import alignment as j_align
from tpufusion.models import landmarks as jl
from tpufusion_torch.data import alignment as t_align
from tpufusion_torch.io.convert import landmark_state_from_jax, state_dict_to_torch
from tpufusion_torch.models import landmarks as tl

TOL = dict(atol=2e-4, rtol=2e-4)
PX_TOL = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u8(img):
    return ((np.clip(img, -1, 1) + 1) * 127.5).astype(np.uint8)


@pytest.fixture(scope="module")
def packaged():
    """(JAX net, JAX variables, port net, input size) of the packaged weights."""
    jnet, jvars, size = jl.load_packaged_landmark_net()
    tnet, tsize = tl.load_packaged_landmark_net(device="cpu")
    assert tsize == size
    return jnet, jvars, tnet, size


@pytest.fixture(scope="module")
def face_file(tmp_path_factory):
    """A 200^2 augmented synthetic face on disk and its true landmarks (px)."""
    imgs, lms = jl.synth_face_batch(np.random.RandomState(5), 1, 200, augment=True)
    path = str(tmp_path_factory.mktemp("faces") / "face.png")
    PIL.Image.fromarray(_u8(imgs[0])).save(path)
    return path, lms[0] * 200


def test_packaged_weights_are_the_jax_packages_bytes():
    for name in ("landmark_net.npz", "landmark_net.json"):
        assert filecmp.cmp(os.path.join(ROOT, "tpufusion", "models", "weights", name),
                           os.path.join(ROOT, "tpufusion_torch", "models", "weights", name),
                           shallow=False), name


def test_forward_matches_jax_on_packaged_weights(packaged):
    jnet, jvars, tnet, size = packaged
    x = jl.synth_face_batch(np.random.RandomState(3), 4, size, augment=True)[0]
    want = np.asarray(jnet.apply(jvars, x))
    got = tl._predict(tnet, x)
    assert got.shape == (4, 68, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_matches_jax_on_a_random_width_8_net():
    jnet, jvars = jl.create_landmark_net(jax.random.key(4), width=8, image_size=40,
                                         policy=JPolicy())
    tnet = tl.LandmarkNet(8, device="cpu")
    tnet.load_state_dict(state_dict_to_torch(landmark_state_from_jax(np_tree(jvars))))
    x = np.random.default_rng(0).uniform(-1, 1, (3, 40, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(tl._predict(tnet, x), np.asarray(jnet.apply(jvars, x)), **TOL)


@pytest.mark.parametrize("flip_tta", [True, False])
def test_provider_pixels_match_jax(packaged, face_file, flip_tta):
    jnet, jvars, tnet, size = packaged
    path, _ = face_file
    want = jl.make_landmark_provider(jnet, jvars, net_input_size=size, flip_tta=flip_tta)(path)
    got = tl.make_landmark_provider(tnet, net_input_size=size, flip_tta=flip_tta)(path)
    assert got.shape == (68, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PX_TOL, rtol=0)


def test_flip_tta_unmirrors_with_one_minus_x():
    """The un-mirror is 1 - x (not (S - 1)/S - x): a point's mirror image
    comes back 1/S off, the bias the JAX package carries (ADVICE.md)."""
    pts = np.random.default_rng(1).uniform(0, 1, (68, 2)).astype(np.float32)
    np.testing.assert_array_equal(tl.FLIP_PERM, jl.FLIP_PERM)
    np.testing.assert_array_equal(tl.flip_landmarks(pts), jl.flip_landmarks(pts))
    np.testing.assert_allclose(tl.flip_landmarks(pts)[tl.FLIP_PERM][:, 0], 1.0 - pts[:, 0])


@pytest.mark.parametrize("augment", [False, True])
def test_synth_face_batch_is_bit_identical(augment):
    a = jl.synth_face_batch(np.random.RandomState(7), 3, 48, augment=augment)
    b = tl.synth_face_batch(np.random.RandomState(7), 3, 48, augment=augment)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_quad_point_weights_match():
    np.testing.assert_array_equal(tl.quad_point_weights(), jl.quad_point_weights())
    np.testing.assert_array_equal(tl.quad_point_weights(5.0), jl.quad_point_weights(5.0))


@pytest.fixture(scope="module")
def trained():
    """A width-8 net trained in torch on 32^2 synthetic faces (the JAX
    test's recipe: 256 faces, 400 Adam steps at lr 3e-3)."""
    imgs, lms = tl.synth_face_batch(np.random.RandomState(0), 256, 32)
    net = tl.create_landmark_net(width=8, device="cpu", seed=0)
    net, trace = tl.train_landmark_net(net, imgs, lms, steps=400, lr=3e-3)
    return net, trace


def test_training_lowers_the_loss_to_a_fifth(trained):
    _, trace = trained
    assert trace.shape == (400,) and torch.isfinite(trace).all()
    assert float(trace[-1]) < float(trace[0]) * 0.2, (float(trace[0]), float(trace[-1]))


def test_weighted_training_runs():
    imgs, lms = tl.synth_face_batch(np.random.RandomState(2), 64, 32)
    net = tl.create_landmark_net(width=8, device="cpu", seed=1)
    _, trace = tl.train_landmark_net(net, imgs, lms, steps=40, batch=32,
                                     point_weights=tl.quad_point_weights())
    assert float(trace[-1]) < float(trace[0])


def test_save_load_roundtrip_and_cross_package(trained, tmp_path):
    net, _ = trained
    x = tl.synth_face_batch(np.random.RandomState(1), 2, 32)[0]
    path = tl.save_landmark_net(net, str(tmp_path / "lm"))
    assert path.endswith(".npz")
    back = tl.load_landmark_net(path, device="cpu")  # width inferred
    assert back.width == 8
    np.testing.assert_array_equal(tl._predict(back, x), tl._predict(net, x))
    # the port's file loads in the JAX package, and JAX's in the port
    jnet, jvars = jl.load_landmark_net(path, policy=JPolicy())
    np.testing.assert_allclose(np.asarray(jnet.apply(jvars, x)), tl._predict(net, x), **TOL)
    jpath = jl.save_landmark_net(jvars, str(tmp_path / "from_jax.npz"))
    np.testing.assert_array_equal(tl._predict(tl.load_landmark_net(jpath, device="cpu"), x),
                                  tl._predict(net, x))


def test_size_sidecar_rules(trained, tmp_path):
    net, _ = trained
    bare = tl.save_landmark_net(net, str(tmp_path / "bare.npz"))
    assert tl.landmark_net_input_size(bare) is None
    sized = tl.save_landmark_net(net, str(tmp_path / "sized.npz"), input_size=32)
    assert tl.landmark_net_input_size(sized) == 32
    with open(sized + ".json") as f:
        assert json.load(f) == {"input_size": 32, "width": 8}
    # a foreign or broken same-stem JSON is not a sidecar
    foreign = tl.save_landmark_net(net, str(tmp_path / "foreign.npz"))
    (tmp_path / "foreign.json").write_text(json.dumps({"lr": 1e-3}))
    assert tl.landmark_net_input_size(foreign) is None
    broken = tl.save_landmark_net(net, str(tmp_path / "broken.npz"))
    (tmp_path / "broken.json").write_text("{not json")
    assert tl.landmark_net_input_size(broken) is None
    # the packaged npz finds its stem sidecar
    assert tl.landmark_net_input_size(os.path.join(tl.WEIGHTS_DIR, "landmark_net.npz")) == 96


def test_packaged_net_matches_sidecar_and_jax_quality(packaged):
    jnet, jvars, tnet, size = packaged
    with open(os.path.join(tl.WEIGHTS_DIR, "landmark_net.json")) as f:
        meta = json.load(f)
    assert tnet.width == meta["width"] and size == meta["input_size"]
    assert tuple(tnet.conv0.weight.shape) == (meta["width"], 3, 3, 3)
    assert not any(p.requires_grad for p in tnet.parameters())
    want = jl.evaluate_landmark_net(jnet, jvars, n=16, size=size, augment=True)
    got = tl.evaluate_landmark_net(tnet, n=16, size=size, augment=True)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=0.011), k
    assert got["mean_landmark_err_px_at_256"] < 25.0


def test_align_face_is_bit_identical_given_the_same_landmarks(tmp_path):
    """On a 640^2 face whose quad needs the shrink, crop and reflect-pad
    branches, and on one that needs none of them."""
    imgs, lms = jl.synth_face_batch(np.random.RandomState(11), 2, 160, augment=True)
    for i, (img, lm, size, out) in enumerate(((imgs[0], lms[0], 640, 64),
                                              (imgs[1], lms[1] * 0.5 + 0.25, 160, 32))):
        path = str(tmp_path / f"face_{i}.png")
        PIL.Image.fromarray(_u8(img)).resize((size, size)).save(path)
        pts = lm * size
        a = np.asarray(j_align.align_face(path, pts, output_size=out))
        b = np.asarray(t_align.align_face(path, pts, output_size=out))
        assert b.shape == (out, out, 3)
        np.testing.assert_array_equal(a, b)
    quad_j, qsize_j = j_align.alignment_quad(pts)
    quad_t, qsize_t = t_align.alignment_quad(pts)
    np.testing.assert_array_equal(quad_j, quad_t)
    assert qsize_j == qsize_t


def test_provider_plus_alignment_matches_jax(packaged, face_file):
    """The packaged provider's landmarks and ``align_face`` end to end: the
    landmarks agree to 1e-3 px, so the aligned 8-bit images differ by at
    most one level (a pixel whose sample lands on a rounding boundary)."""
    jnet, jvars, tnet, size = packaged
    path, _ = face_file
    a = np.asarray(j_align.make_align_preprocess(
        jl.make_landmark_provider(jnet, jvars, net_input_size=size))(path), np.int16)
    b = np.asarray(t_align.make_align_preprocess(
        tl.make_landmark_provider(tnet, net_input_size=size))(path), np.int16)
    assert b.shape == (256, 256, 3)
    assert np.abs(a - b).max() <= 1


def test_resolve_align_preprocess_paths(trained, face_file, tmp_path):
    """The CLI helper: a weights file with its sidecar size, and the
    packaged net when no file is given."""
    net, _ = trained
    path, _ = face_file
    weights = tl.save_landmark_net(net, str(tmp_path / "lm.npz"), input_size=32)
    img = t_align.resolve_align_preprocess(weights, None, output_size=48, device="cpu")(path)
    assert img.size == (48, 48)
    img = t_align.resolve_align_preprocess(None, None, output_size=48, device="cpu")(path)
    assert img.size == (48, 48)

"""Parity of the port's classifiers with the JAX package, CPU, float32.

- a width-8 ResNet and the runner's tiny ViT (`runner.py:105-108`) on the
  same weights: logits and pixel gradients through the adapters' resize
  (48^2 -> 32^2 inside the differentiated function) to 2e-4 of the largest
  entry;
- checkpoints written by the test: a torchvision-layout resnet18 state dict
  and an HF-layout ViT ``pytorch_model.bin`` give the same logits through
  JAX's converters and the port's ``load_state_dict``; so does a dir that
  holds only ``model.safetensors``;
- the runner's classifier-PGD recipe (`runner.py:388-398`: clean-argmax
  labels, mean softmax cross-entropy, doubled eps and alpha) against JAX's
  ``make_pgd(external_start=True)`` for one step from a shared start, held as
  the fusion PGD is (``tests/test_torch_fusion_attack.py``); 5 port steps
  from a random start ascend the loss and stay in the eps-ball.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tests.torch_pipelines import np_tree, one_torch_thread  # noqa: F401
from tpufusion.attacks.pgd import PGDConfig as JPGDConfig
from tpufusion.attacks.pgd import make_pgd as j_make_pgd
from tpufusion.core.dtypes import Policy as JPolicy
from tpufusion.models import classifiers as jc
from tpufusion.models.resnet import ResNet as JResNet
from tpufusion_torch.attacks.pgd import PGDConfig, make_pgd
from tpufusion_torch.io.checkpoint import load_named_state
from tpufusion_torch.io.convert import (
    resnet_state_from_jax,
    state_dict_to_torch,
    vit_state_from_jax,
)
from tpufusion_torch.models import classifiers as tc
from tpufusion_torch.models.resnet import ResNet

TOL = 2e-4
TINY_VIT = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64)
EPS, ALPHA = 8 / 255 * 2, 0.01 * 2  # configs/ffhq_classifier_transfer.json, doubled


def _perturbed(tree, rng):
    """The JAX variables with every batch-norm statistic and LayerNorm and
    bias entry drawn at random, so that no layer is the identity."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node)
        if path[-1] == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        if path[-1] in ("mean", "bias", "cls_token"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if path[-1] == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a
    return walk(tree, ())


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(21)
    return rng.uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def resnets():
    jm = JResNet(num_classes=2, width=8, policy=JPolicy())
    jv = jax.jit(jm.init)(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))
    jv = _perturbed(np_tree(jv), np.random.default_rng(4))
    tm = ResNet(2, width=8, device="cpu", generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(state_dict_to_torch(resnet_state_from_jax(jv)))
    tm.requires_grad_(False)
    return jc.resnet_logits_fn(jm, jv, input_size=32), jv, tc.resnet_logits_fn(32), tm


@pytest.fixture(scope="module")
def vits():
    j_fn, jv = jc.create_vit_classifier(8, seed=5, **TINY_VIT)
    jv = _perturbed(np_tree(jv), np.random.default_rng(6))
    t_fn, tm = tc.create_vit_classifier(8, device="cpu", **TINY_VIT)
    tm.load_state_dict(state_dict_to_torch(vit_state_from_jax(jv)))
    return j_fn, jv, t_fn, tm


def _logits_and_grad_j(fn, params, x):
    w = jnp.asarray(np.linspace(-1, 1, 16, dtype=np.float32))

    def f(x_):
        logits = fn(params, x_)
        return jnp.sum(logits * w[: logits.shape[-1]]), logits

    (_, logits), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x))
    return np.asarray(logits), np.asarray(g)


def _logits_and_grad_t(fn, model, x):
    w = torch.linspace(-1, 1, 16)
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = fn(model, xt)
    (g,) = torch.autograd.grad((logits * w[: logits.shape[-1]]).sum(), xt)
    return logits.detach().numpy(), g.numpy()


@pytest.mark.parametrize("which", ["resnet", "vit"])
def test_logits_and_pixel_gradients_match_jax(which, resnets, vits, images):
    j_fn, jv, t_fn, tm = resnets if which == "resnet" else vits
    lj, gj = _logits_and_grad_j(j_fn, jv, images)
    lt, gt = _logits_and_grad_t(t_fn, tm, images)
    assert lt.shape == (2, 2 if which == "resnet" else 8) and lt.dtype == np.float32
    _close(lt, lj)
    _close(gt, gj)
    assert np.abs(gj).max() > 0


def test_torchvision_resnet18_state_dict_loads_in_both(tmp_path, images):
    """A resnet18 checkpoint in torchvision's layout (written here): the JAX
    package's ``load_gender_classifier`` and the port's give the same
    logits; the port's ``load_state_dict`` takes it unchanged."""
    rng = np.random.default_rng(7)
    ref = ResNet(2, device="cpu", generator=torch.Generator().manual_seed(1))
    sd = {}
    for k, v in ref.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0)
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, tuple(v.shape)).astype(np.float32))
        else:
            sd[k] = v + 0.05 * torch.from_numpy(rng.standard_normal(tuple(v.shape))).float()
    path = str(tmp_path / "gender.pth")
    torch.save(sd, path)
    j_fn, jv = jc.load_gender_classifier(path)
    t_fn, tm = tc.load_gender_classifier(path, device="cpu")
    x = images[:, :32, :32]  # resized to 256^2 inside both adapters
    lj = np.asarray(jax.jit(j_fn)(jv, jnp.asarray(x)))
    with torch.no_grad():
        lt = t_fn(tm, torch.from_numpy(x)).numpy()
        ref.load_state_dict(sd)
        lr = t_fn(ref, torch.from_numpy(x)).numpy()
    _close(lt, lj)
    np.testing.assert_array_equal(lr, lt)


def test_hf_vit_state_dict_loads_in_both(tmp_path, vits, images):
    """An HF-layout ``pytorch_model.bin`` (written here from JAX weights
    carried to HF names) gives JAX's logits through ``convert_vit_checkpoint``
    and the port's through ``load_state_dict``."""
    _, jv, _, tm = vits
    torch.save({k: v.clone() for k, v in tm.state_dict().items()},
               str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "config.json").write_text(json.dumps({"num_labels": 8}))
    j_fn, jp = jc.create_vit_classifier(8, pretrained_dir=str(tmp_path), **TINY_VIT)
    t_fn, tm2 = tc.create_vit_classifier(8, pretrained_dir=str(tmp_path), device="cpu",
                                         **TINY_VIT)
    lj = np.asarray(jax.jit(j_fn)(jp, jnp.asarray(images)))
    with torch.no_grad():
        lt = t_fn(tm2, torch.from_numpy(images)).numpy()
    _close(lt, lj)
    for k, v in np_tree(jp["params"]).items():
        if not isinstance(v, dict):
            np.testing.assert_array_equal(v, np.asarray(jv["params"][k]))


def _write_safetensors(path, tensors):
    """The safetensors layout, written by hand (no package needed): an
    8-byte header length, a JSON header, the raw little-endian bytes."""
    header, offset, blobs = {}, 0, []
    for name, a in tensors.items():
        b = np.ascontiguousarray(a, dtype="<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(b)]}
        offset += len(b)
        blobs.append(b)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h + b"".join(blobs))


def test_safetensors_dir_loads_in_both(tmp_path, vits, images):
    """A dir holding only ``model.safetensors``: both packages read it with
    ``torch.load``, which parses the safetensors layout in the torch these
    tests run on, and give the same logits (ROADMAP §C)."""
    _, jv, _, tm = vits
    _write_safetensors(str(tmp_path / "model.safetensors"),
                       {k: v.numpy() for k, v in tm.state_dict().items()})
    j_fn, jp = jc.create_vit_classifier(8, pretrained_dir=str(tmp_path), **TINY_VIT)
    t_fn, tm2 = tc.create_vit_classifier(8, pretrained_dir=str(tmp_path), device="cpu",
                                         **TINY_VIT)
    lj = np.asarray(jax.jit(j_fn)(jp, jnp.asarray(images)))
    with torch.no_grad():
        lt = t_fn(tm2, torch.from_numpy(images)).numpy()
    _close(lt, lj)
    for k, v in tm.state_dict().items():
        assert torch.equal(tm2.state_dict()[k], v), k


def test_backends_resolve_as_jax_and_flax_hf_raises(tmp_path):
    empty, flax_only, both = (tmp_path / n for n in ("empty", "flax", "both"))
    for d in (empty, flax_only, both):
        d.mkdir()
    (flax_only / "flax_model.msgpack").write_bytes(b"")
    (both / "flax_model.msgpack").write_bytes(b"")
    (both / "pytorch_model.bin").write_bytes(b"")
    for d in (None, str(empty), str(flax_only), str(both)):
        assert tc.resolve_vit_backend(d) == jc.resolve_vit_backend(d)
    assert tc.resolve_vit_backend(str(flax_only)) == "flax_hf"
    with pytest.raises(ValueError, match="no counterpart in tpufusion_torch"):
        tc.create_vit_classifier(8, pretrained_dir=str(flax_only), device="cpu", **TINY_VIT)
    with pytest.raises(ValueError, match="unknown ViT backend"):
        tc.create_vit_classifier(8, backend="onnx", device="cpu", **TINY_VIT)
    with pytest.raises(FileNotFoundError, match="no pytorch_model.bin"):
        tc.create_vit_classifier(8, pretrained_dir=str(empty), backend="native",
                                 device="cpu", **TINY_VIT)


def test_missing_checkpoint_entry_raises(resnets):
    *_, tm = resnets
    sd = dict(tm.state_dict())
    sd.pop("layer2.0.downsample.0.weight")
    with pytest.raises(KeyError, match="downsample"):
        load_named_state(tm, sd)
    sd = {k: v for k, v in tm.state_dict().items() if not k.endswith("num_batches_tracked")}
    load_named_state(tm, dict(sd, extra=torch.zeros(1)))  # extras ignored


def _ce_j(fn):
    def loss(adv, params, labels):
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            fn(params, adv), labels))
    return loss


def _ce_t(fn):
    def loss(adv, model, labels):
        return F.cross_entropy(fn(model, adv), labels)
    return loss


@pytest.mark.parametrize("which", ["resnet", "vit"])
def test_classifier_pgd_step_matches_jax(which, resnets, vits, images):
    j_fn, jv, t_fn, tm = resnets if which == "resnet" else vits
    x = images
    start = np.clip(x + np.random.default_rng(8).uniform(-EPS, EPS, x.shape), -1, 1
                    ).astype(np.float32)
    labels_j = jnp.argmax(jax.jit(j_fn)(jv, jnp.asarray(x)), axis=-1)
    with torch.no_grad():
        labels_t = t_fn(tm, torch.from_numpy(x)).argmax(dim=-1)
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    jcfg = JPGDConfig(eps=EPS, alpha=ALPHA, steps=1)
    adv_j, tr_j = j_make_pgd(_ce_j(j_fn), jcfg, external_start=True)(
        jnp.asarray(x), jnp.asarray(start), jv, labels_j)
    g_j = np.asarray(jax.jit(jax.grad(_ce_j(j_fn)))(jnp.asarray(start), jv, labels_j))
    adv_t, tr_t = make_pgd(_ce_t(t_fn), PGDConfig(eps=EPS, alpha=ALPHA, steps=1),
                           external_start=True)(torch.from_numpy(x),
                                                torch.from_numpy(start), tm, labels_t)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), atol=TOL, rtol=TOL)
    mask = np.abs(g_j) > 1e-6 * np.abs(g_j).max()
    assert mask.mean() > 0.5
    np.testing.assert_allclose(adv_t.numpy()[mask], np.asarray(adv_j)[mask], atol=1e-6,
                               rtol=0)


def test_classifier_pgd_recipe_ascends_within_the_ball(resnets, images):
    """5 steps of the runner's recipe from a random start: the CE rises and
    every pixel stays within eps of its input and in [-1, 1]."""
    *_, t_fn, tm = resnets
    x = torch.from_numpy(images)
    with torch.no_grad():
        labels = t_fn(tm, x).argmax(dim=-1)
    adv, trace = make_pgd(_ce_t(t_fn), PGDConfig(eps=EPS, alpha=ALPHA, steps=5))(
        x, torch.Generator().manual_seed(2), tm, labels)
    assert trace.shape == (5,) and torch.isfinite(trace).all()
    with torch.no_grad():
        final = _ce_t(t_fn)(adv, tm, labels)
    assert final > trace[0]
    assert (adv - x).abs().max() <= EPS + 1e-6
    assert adv.min() >= -1 and adv.max() <= 1

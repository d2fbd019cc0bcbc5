"""Parity of the port's LPIPS network and the legacy ``optimize`` /
``optimize_copy`` white-box variants with the JAX package.

- ``LPIPS`` against JAX's on the JAX variables carried in through
  ``io.convert.lpips_state_from_jax`` (1e-5), also with one batch of 1
  broadcast against a batch of 2;
- against ``tests/torch_ref.py``'s independent ``LPIPST``: its official
  state dict (``net.slice*`` + ``lin*.model.1``), and the pip package's
  lin-only checkpoint plus a torchvision ``features`` dict, through
  ``convert_torch_lpips`` and through files with ``load_torch_lpips``
  (rtol 1e-4, atol 1e-5, JAX's own bounds for this oracle);
- the shape and layout errors; identical inputs give 0;
- both legacy variants against JAX over 3 iterations with
  ``snapshot_every`` 2: every trace term to atol = rtol = 2e-4, frame 0
  the original exactly, the pixels of frame 1 and of the result to 0.02 lr
  where the first step's |g| > 1e-6 (Adam's bound argument of
  ``tests/test_torch_whitebox.py``); the bad-variant error; and
  ``snapshot_every`` 0: no frames, the same trajectory.
CPU, float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import np_tree, one_torch_thread, port_of  # noqa: F401
from tests.torch_ref import LPIPST
from tpufusion.attacks import whitebox as jwb
from tpufusion.core.dtypes import Policy as JPolicy
from tpufusion.models.lpips import create_lpips
from tpufusion.pipeline import create_test_pipeline
from tpufusion_torch.attacks import whitebox as wb
from tpufusion_torch.core.dtypes import Policy
from tpufusion_torch.io.convert import lpips_state_from_jax, state_dict_to_torch
from tpufusion_torch.models.lpips import LPIPS, convert_torch_lpips, load_torch_lpips

LR = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(seed, n=2, size=64):
    rng = np.random.RandomState(seed)
    return (np.tanh(rng.randn(n, size, size, 3)).astype(np.float32),
            np.tanh(rng.randn(n, size, size, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_lpips():
    model, variables = create_lpips(jax.random.key(7), policy=JPolicy(), image_size=32)
    port = LPIPS(device="cpu", policy=Policy())
    port.load_state_dict(state_dict_to_torch(lpips_state_from_jax(np_tree(variables))))
    return model, variables, port


def test_lpips_matches_jax(jax_lpips):
    model, variables, port = jax_lpips
    x0, x1 = _pair(3)
    for a, b in ((x0, x1), (x0[:1], x1), (x0, x1[:1])):
        want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(a), jnp.asarray(b)))
        with torch.no_grad():
            got = port(_t(a), _t(b)).numpy()
        assert got.shape == want.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(port(_t(x0), _t(x0)), torch.zeros(2))


def _oracle_check(port, t, seed):
    x0, x1 = _pair(seed)
    with torch.no_grad():
        want = t(_t(x0).permute(0, 3, 1, 2), _t(x1).permute(0, 3, 1, 2)).numpy()
        got = port(_t(x0), _t(x1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_official_layouts_match_torch_oracle(tmp_path):
    torch.manual_seed(21)
    t = LPIPST().eval()
    full = t.state_dict_official()
    port = LPIPS(device="cpu", policy=Policy())
    port.load_state_dict(convert_torch_lpips(full))
    _oracle_check(port, t, 4)
    lin_only = {k: v for k, v in full.items() if k.startswith("lin")}
    port = LPIPS(device="cpu", policy=Policy())
    port.load_state_dict(convert_torch_lpips(lin_only, backbone=t.backbone_features_dict()))
    _oracle_check(port, t, 5)
    torch.save(_to_torch(full), tmp_path / "lpips.pth")
    torch.save(_to_torch(lin_only), tmp_path / "vgg.pth")
    torch.save(_to_torch(t.backbone_features_dict()), tmp_path / "features.pth")
    for args in ((tmp_path / "lpips.pth",), (tmp_path / "vgg.pth", tmp_path / "features.pth")):
        loaded = load_torch_lpips(*map(str, args), policy=Policy(), device="cpu")
        assert not any(p.requires_grad for p in loaded.parameters())
        _oracle_check(loaded, t, 6)


def test_bad_shapes_and_layouts_raise(jax_lpips):
    port = jax_lpips[2]
    x = torch.zeros(2, 32, 32, 3)
    for a, b in ((x, torch.zeros(2, 16, 16, 3)), (x, torch.zeros(2, 32, 32, 1)),
                 (x[0], x[0]), (torch.zeros(2, 32, 32, 4), torch.zeros(2, 32, 32, 4))):
        with pytest.raises(ValueError, match="NHWC RGB"):
            port(a, b)
    with pytest.raises(ValueError, match="broadcast"):
        port(x, torch.zeros(3, 32, 32, 3))
    torch.manual_seed(23)
    full = LPIPST().state_dict_official()
    with pytest.raises(ValueError, match="backbone"):
        convert_torch_lpips({k: v for k, v in full.items() if k.startswith("lin")})
    with pytest.raises(ValueError, match="no lin4"):
        convert_torch_lpips({k: v for k, v in full.items() if not k.startswith("lin4")})
    with pytest.raises(ValueError, match="expected 13 backbone convs"):
        convert_torch_lpips({k: v for k, v in full.items() if not k.startswith("net.slice5")})
    bad = dict(full, **{"lin0.model.1.weight": np.zeros((1, 32, 1, 1), np.float32)})
    with pytest.raises(ValueError, match=r"lin0: expected \(1, 64, 1, 1\)"):
        convert_torch_lpips(bad)


@pytest.fixture(scope="module")
def legacy_runs(jax_lpips):
    """Both variants, 3 iterations, snapshots every 2, by both packages on
    the JAX test pipeline's weights, plus the first step's |g| > 1e-6 mask."""
    jp = create_test_pipeline("ffhq", jax.random.key(0), size=32)
    tp = port_of(jp)
    model, variables, port = jax_lpips
    rng = np.random.default_rng(51)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    out = {}
    for variant in ("optimize", "optimize_copy"):
        kw = dict(lr=LR, n_iters=3, variant=variant, snapshot_every=2)
        j = jwb.make_legacy_optimize(jp, model, variables, jwb.LegacyOptimizeConfig(**kw))(
            jnp.asarray(img), jnp.asarray(target))
        cfg = wb.LegacyOptimizeConfig(**kw)
        got = wb.make_legacy_optimize(tp, port, cfg)(_t(img), _t(target))
        ref_fn, loss_fn = wb._make_legacy_loss(tp, port, variant)
        x = _t(img).requires_grad_(True)
        total, _ = loss_fn(x, ref_fn(_t(img), _t(target)))
        mask = np.abs(torch.autograd.grad(total, x)[0].numpy()) > 1e-6
        out[variant] = j, got, mask, cfg
    return tp, port, img, target, out


@pytest.mark.parametrize("variant", ["optimize", "optimize_copy"])
def test_legacy_optimize_matches_jax(legacy_runs, variant):
    _, _, img, _, out = legacy_runs
    (j_adv, j_trace, j_snaps), (adv, trace, snaps), mask, _ = out[variant]
    assert mask.mean() > 0.5
    assert sorted(trace) == sorted(j_trace) == ["img_org", "img_rec", "latent", "lpips_rec",
                                                 "total"]
    for k, v in trace.items():
        assert tuple(v.shape) == (3,) == np.shape(j_trace[k]), k
        np.testing.assert_allclose(v.numpy(), np.asarray(j_trace[k]), atol=2e-4, rtol=2e-4,
                                   err_msg=k)
    assert float(trace["total"][-1]) < float(trace["total"][0])
    assert isinstance(snaps, np.ndarray) and snaps.shape == (2, 1, 32, 32, 3) == j_snaps.shape
    np.testing.assert_array_equal(snaps[0], img)
    for got, want in ((snaps[1], np.asarray(j_snaps)[1]), (adv.numpy(), np.asarray(j_adv))):
        np.testing.assert_allclose(got[mask], want[mask], atol=0.02 * LR, rtol=0)
    # frame 1 lands after 3 = 1 + 1 * 2 steps: here the final pixels
    np.testing.assert_array_equal(snaps[1], adv.numpy())


def test_legacy_bad_variant_and_no_snapshots(legacy_runs):
    tp, port, img, target, out = legacy_runs
    with pytest.raises(ValueError, match="unknown legacy variant"):
        wb.make_legacy_optimize(tp, port, wb.LegacyOptimizeConfig(variant="nope"))
    (_, _, _), (adv, trace, _), _, cfg = out["optimize"]
    adv0, trace0, snaps0 = wb.make_legacy_optimize(
        tp, port, dataclasses.replace(cfg, snapshot_every=0))(_t(img), _t(target))
    assert snaps0.shape == (0, 1, 32, 32, 3)
    assert torch.equal(adv0, adv)
    for k in trace:
        assert torch.equal(trace0[k], trace[k]), k
    assert dataclasses.asdict(wb.LegacyOptimizeConfig()) == dataclasses.asdict(
        jwb.LegacyOptimizeConfig())

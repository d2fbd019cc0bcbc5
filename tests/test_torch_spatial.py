"""Parity of the port's fusion hierarchy, drawer and spatial fusion with the
JAX package and its committed fusion goldens.

- the blender's forward against JAX's on random style vectors (1e-5), a
  manifest written by the JAX package's ``save_fusion_nets`` and one written
  by the port, the reference's torch ``.pt`` fusion nets (chained, a width
  mismatch, an unchained stack: same output, report and printed lines as
  the JAX ingestion), and the identity and convexity of the blend;
- the drawer: ``generate_img`` without and with every FFHQ swap, each latent
  type of ``general_latent_to_s``, ``w_plus_dict_to_image`` with
  truncation, ``z_to_w_plus`` and the error paths (2e-4); a supplied
  decoder;
- ``spatial_fusion`` and ``arithmetic_fusion`` against the fusion goldens of
  ffhq, car and church at 32^2 (2e-4), the JAX drawer's weights carried in
  through ``tpufusion_torch.io.convert``;
- ``FusionPipeline.create`` draws the generator, encoder and VGG weights of a
  seed as before the fusion nets were added, the nets after them.
CPU, float32.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tpufusion.core.dtypes import Policy as JPolicy
from tpufusion.fusion.drawer import FusionDrawer as JDrawer
from tpufusion.models.fusion_hierarchy import HierarchyBlender as JBlender
from tpufusion_torch.fusion import FusionDrawer, arithmetic_fusion, spatial_fusion
from tpufusion_torch.io.convert import (
    blender_state_from_jax,
    generator_state_from_jax,
    state_dict_to_torch,
)
from tpufusion_torch.models.fusion_hierarchy import (
    TREES,
    ChainedMLP,
    EvenBlend,
    HierarchyBlender,
    get_all_active_parts,
)
from tpufusion_torch.models.stylegan2 import Generator

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
TOL = dict(atol=2e-4, rtol=2e-4)
DIMS = (8, 16, 8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_blender(dataset, dims, jax_params):
    b = HierarchyBlender(dataset, dims, device="cpu")
    b.load_state_dict(state_dict_to_torch(blender_state_from_jax(_np(jax_params))))
    return b


def _port_drawer(jd):
    gen = Generator(32, channel_multiplier=1, device="cpu")
    gen.load_state_dict(state_dict_to_torch(generator_state_from_jax(_np(jd.gen_vars), 32)))
    gen.requires_grad_(False)
    blender = _port_blender(jd.dataset, gen.style_input_dims(), jd.blend_params)
    return FusionDrawer(jd.dataset, gen, torch.from_numpy(np.array(jd.mean_latent)), blender)


@pytest.fixture(scope="module")
def drawers():
    """One JAX drawer per dataset, built as tests/test_goldens.py builds it,
    and the port's drawer on its weights."""
    cache = {}

    def get(dataset):
        if dataset not in cache:
            jd = JDrawer.create(dataset, jax.random.key(7), size=32, channel_multiplier=1,
                                mean_latent_samples=8)
            cache[dataset] = jd, _port_drawer(jd)
        return cache[dataset]

    return get


def _random_s_dict(dataset, dims, seed, n=2):
    rng = np.random.default_rng(seed)
    return {p: tuple(rng.standard_normal((n, d)).astype(np.float32) for d in dims)
            for p in get_all_active_parts(TREES[dataset])}


def _blend_both(jb, params, tb, s_np):
    want = jb.forward(params, {k: tuple(map(jnp.asarray, v)) for k, v in s_np.items()})
    with torch.no_grad():
        got = tb({k: tuple(map(torch.from_numpy, v)) for k, v in s_np.items()})
    return got, want


def _assert_styles_close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# blender
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["ffhq", "car", "church"])
def test_blender_forward_matches_jax(dataset):
    jb = JBlender(dataset, DIMS, policy=JPolicy())
    params = jb.init_params(jax.random.key(3))
    tb = _port_blender(dataset, DIMS, params)
    assert sorted(tb.nets) == sorted(jb.internal_nodes)
    _assert_styles_close(*_blend_both(jb, params, tb, _random_s_dict(dataset, DIMS, 4)), 1e-5)


def test_init_is_flax_lecun_normal():
    """Kernels are LeCun normal truncated at 2 std (flax's Dense default),
    biases zero: the same distribution as the JAX blender's."""
    dims = (512, 256)
    tb = HierarchyBlender("church", dims, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    jb = JBlender("church", dims, policy=JPolicy())
    jp = _np(jb.init_params(jax.random.key(0)))
    for node in tb.nets:
        for i, d in enumerate(dims):
            for layer, fan_in in ((f"gate{i}_fc1", 3 * d), (f"gate{i}_fc2", 128)):
                w = getattr(tb.nets[node], layer).weight.detach().numpy()
                k = jp[node]["params"][layer]["kernel"]
                for arr in (w, k):
                    assert abs(arr.std() * np.sqrt(fan_in) - 1) < 0.03
                    assert np.abs(arr).max() <= 2 / np.sqrt(fan_in) / 0.8796256610342398 + 1e-6
                    assert abs(arr.mean()) < 0.01
                assert not getattr(tb.nets[node], layer).bias.detach().any()


def test_identity_and_convexity():
    tb = HierarchyBlender("ffhq", DIMS, device="cpu", generator=torch.Generator().manual_seed(1))
    parts = get_all_active_parts(tb.tree)
    s = tuple(torch.full((1, d), float(i + 2)) for i, d in enumerate(DIMS))
    with torch.no_grad():
        out = tb({p: s for p in parts})
        for a, b in zip(out, s):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
        lo = tuple(torch.zeros(1, d) for d in DIMS)
        s_dict = {p: lo for p in parts}
        s_dict["hair"] = tuple(torch.ones(1, d) for d in DIMS)
        out = tb(s_dict)
    assert all(bool(((o >= -1e-6) & (o <= 1 + 1e-6)).all()) for o in out)
    assert any(bool((o > 1e-3).any()) for o in out)  # the differing leaf moved it


def test_npz_manifests_cross_between_packages(tmp_path):
    """A manifest written by the JAX package loads into the port and blends
    identically; one written by the port loads into JAX with the same
    weights."""
    jb = JBlender("ffhq", DIMS, policy=JPolicy())
    params = jb.init_params(jax.random.key(5))
    manifest = jb.save_fusion_nets(params, str(tmp_path / "jax"), "ffhq.json")
    tb = HierarchyBlender("ffhq", DIMS, device="cpu")
    report = tb.load_fusion_nets(manifest)
    jb.load_fusion_nets(manifest)
    assert report == jb.load_report == tb.load_report
    assert not report["approx"]
    _assert_styles_close(*_blend_both(jb, params, tb, _random_s_dict("ffhq", DIMS, 6)), 1e-5)

    back = jb.load_fusion_nets(tb.save_fusion_nets(str(tmp_path / "port"), "ffhq.json"))
    for node, p in _np(params).items():
        for layer, kv in p["params"].items():
            for key, v in kv.items():
                np.testing.assert_array_equal(np.asarray(back[node]["params"][layer][key]), v)


def _torch_nets(case, d, nodes):
    gen = torch.Generator().manual_seed(3)

    def rn(*shape, scale=0.4):
        return torch.randn(shape, generator=gen) * scale

    out = {}
    for node in nodes:
        if case == "chained":  # Linear(3d -> 16) -> Linear(16 -> d), under a wrapper key
            out[node] = {"state_dict": {"mlp.0.weight": rn(16, 3 * d), "mlp.0.bias": rn(16),
                                        "mlp.2.weight": rn(d, 16), "mlp.2.bias": rn(d)}}
        elif case == "width_mismatch":  # serves no style layer
            out[node] = {"fc.weight": rn(5, 7), "fc.bias": rn(5)}
        else:  # parallel heads: 16 != 3d breaks the chain
            out[node] = {"gate.weight": rn(16, 3 * d), "gate.bias": rn(16),
                         "value.weight": rn(d, 3 * d), "value.bias": rn(d)}
    return out


@pytest.mark.parametrize("case,form", [("chained", ChainedMLP), ("width_mismatch", ChainedMLP),
                                       ("unchained", EvenBlend)])
def test_torch_manifest_matches_jax_ingestion(tmp_path, capsys, case, form):
    d, dims = 8, (8, 8)
    jb = JBlender("church", dims, policy=JPolicy())
    for node, sd in _torch_nets(case, d, jb.internal_nodes).items():
        torch.save(sd, tmp_path / f"{node}.pt")
    manifest = tmp_path / "church.json"
    manifest.write_text(json.dumps({n: f"{n}.pt" for n in jb.internal_nodes}))

    params = jb.load_fusion_nets(str(manifest))
    printed_jax = capsys.readouterr().out
    tb = HierarchyBlender("church", dims, device="cpu")
    report = tb.load_fusion_nets(str(manifest))
    assert capsys.readouterr().out == printed_jax
    assert report == jb.load_report
    assert all(isinstance(net, form) for net in tb.nets.values())
    assert report["approx"] == (case != "chained")
    _assert_styles_close(*_blend_both(jb, params, tb, _random_s_dict("church", dims, 7)), 1e-5)


# ---------------------------------------------------------------------------
# drawer
# ---------------------------------------------------------------------------

def _z(seed, n=1):
    return np.random.default_rng(seed).standard_normal((n, 512)).astype(np.float32)


def test_generate_img_without_and_with_every_ffhq_swap(drawers):
    jd, td = drawers("ffhq")
    base = _z(10)
    swaps = {kw: _z(11 + i) for i, kw in
             enumerate(("hair", "face", "background", "all", "mouth", "eyes"))}
    for kw in ({}, swaps):
        img_j, feats_j = jd.generate_img(jnp.asarray(base), latents_type="z",
                                         **{k: jnp.asarray(v) for k, v in kw.items()})
        with torch.no_grad():
            img_t, feats_t = td.generate_img(torch.from_numpy(base), latents_type="z",
                                             **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), **TOL)
        np.testing.assert_allclose(feats_t[-1].numpy(), np.asarray(feats_j[-1]), **TOL)


def test_latent_conversions_match_jax(drawers):
    jd, td = drawers("ffhq")
    rng = np.random.default_rng(12)
    w = rng.standard_normal((1, 512)).astype(np.float32)
    w_plus = rng.standard_normal((2, 8, 512)).astype(np.float32)
    z = _z(13, 2)
    s = tuple(rng.standard_normal((2, d)).astype(np.float32) for d in td.generator.style_input_dims())
    for latent, kind in ((z, "z"), (w, "w"), (w_plus, "w+"), (s, "s")):
        want = jd.general_latent_to_s(jax.tree.map(jnp.asarray, latent), kind)
        with torch.no_grad():
            got = td.general_latent_to_s(jax.tree.map(torch.from_numpy, latent), kind)
        _assert_styles_close(got, want, 2e-4)
    with torch.no_grad():
        np.testing.assert_allclose(td.z_to_w_plus(torch.from_numpy(z)).numpy(),
                                   np.asarray(jd.z_to_w_plus(jnp.asarray(z))), **TOL)
        parts = {"all": w_plus[:1], "hair": w_plus[1:]}
        got, _ = td.w_plus_dict_to_image({k: torch.from_numpy(v) for k, v in parts.items()},
                                         truncation=0.7)
    want, _ = jd.w_plus_dict_to_image({k: jnp.asarray(v) for k, v in parts.items()},
                                      truncation=0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_drawer_error_paths_and_seed_to_z(drawers):
    _, td = drawers("ffhq")
    z = torch.from_numpy(_z(14))
    with pytest.raises(TypeError, match="unknown part keywords"):
        td.generate_img(z, nose=z)
    with pytest.raises(ValueError, match="latents_type"):
        td.generate_img(z, latents_type="q")
    with pytest.raises(ValueError, match="latents_type"):
        td.general_latent_to_s(z, "zz")
    with pytest.raises(ValueError, match="'all'"):
        td.z_dict_to_image({"hair": z})
    a, b, c = td.seed_to_z((6, 7)), td.seed_to_z((6, 7)), td.seed_to_z((6, 3))
    assert tuple(a.shape) == (1, 512) and torch.equal(a, b) and not torch.equal(a, c)


def test_drawer_wraps_a_supplied_decoder(drawers):
    """``FusionDrawer.create(decoder=...)`` wraps the given generator (the
    reference's ``GAN=net.decoder`` path), freezes it and draws the mean
    latent, then the fusion nets, from ``generator``."""
    _, td = drawers("church")
    gen = torch.Generator().manual_seed(8)
    d = FusionDrawer.create("church", decoder=td.generator, mean_latent_samples=8,
                            generator=gen)
    assert d.generator is td.generator and d.device.type == "cpu"
    assert not any(p.requires_grad for p in d.generator.parameters())
    ref = torch.Generator().manual_seed(8)
    with torch.no_grad():
        mean = td.generator.mean_latent(8, generator=ref)
    torch.testing.assert_close(d.mean_latent, mean, atol=0, rtol=0)
    blender = HierarchyBlender("church", td.generator.style_input_dims(), device="cpu",
                               generator=ref)
    for k, v in blender.state_dict().items():
        assert torch.equal(d.blender.state_dict()[k], v), k


@pytest.mark.parametrize("dataset", ["ffhq", "car", "church"])
def test_fusion_goldens(drawers, dataset):
    _, td = drawers(dataset)
    with np.load(os.path.join(GOLDEN_DIR, f"fusion_{dataset}_32_seed7.npz")) as g:
        w, golden_sp, golden_ar, golden_singles = (g["w"], g["fused_spatial"], g["fused_arith"],
                                                   g["singles"])
    with torch.no_grad():
        fused_sp, singles, feats = spatial_fusion(td, torch.from_numpy(w))
        fused_ar, _, _ = arithmetic_fusion(td, torch.from_numpy(w))
    np.testing.assert_allclose(fused_sp.numpy(), golden_sp, **TOL)
    np.testing.assert_allclose(fused_ar.numpy(), golden_ar, **TOL)
    np.testing.assert_allclose(singles.numpy(), golden_singles, **TOL)
    assert feats.shape[0] == w.shape[0]


def test_spatial_fusion_needs_the_role_count(drawers):
    _, td = drawers("church")
    with pytest.raises(ValueError, match="needs 3 latents, got 2"):
        spatial_fusion(td, torch.zeros(2, 8, 512))


# ---------------------------------------------------------------------------
# the pipeline's draw order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_pipeline_seed_keeps_its_weights(seed):
    """Generator, mean latent, encoder and VGG drawn from the seed's
    ``torch.Generator`` in the order they had before the fusion nets; the
    nets come last."""
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.models.e4e import Encoder4Editing
    from tpufusion_torch.models.vgg16 import VGG16
    from tpufusion_torch.pipeline import FusionPipeline

    kw = dict(size=32, channel_multiplier=1, encoder_base_channels=16,
              encoder_units=(1, 1, 1, 1), encoder_input_size=32, mean_latent_samples=16)
    p = FusionPipeline.create("ffhq", device="cpu", seed=seed, **kw)
    gen = torch.Generator().manual_seed(seed)
    g = Generator(32, channel_multiplier=1, policy=Policy(), device="cpu", generator=gen)
    mean = g.mean_latent(16, generator=gen)
    enc = Encoder4Editing(g.n_latent, base_channels=16, unit_counts=(1, 1, 1, 1),
                          input_size=32, policy=Policy(), device="cpu", generator=gen)
    vgg = VGG16(policy=Policy(), device="cpu", generator=gen)
    blender = HierarchyBlender("ffhq", g.style_input_dims(), device="cpu", generator=gen)
    for ours, ref in ((p.generator, g), (p.encoder, enc), (p.vgg, vgg),
                      (p.drawer.blender, blender)):
        got, want = ours.state_dict(), ref.state_dict()
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert torch.equal(p.drawer.mean_latent, mean)
    assert not any(t.requires_grad for t in p.drawer.blender.parameters())

"""Parity of the port's generator, drawer and arithmetic fusion with the JAX
package and its committed goldens.

JAX-init weights are carried into the port by ``tpufusion_torch.io.convert``.
CPU, float32; tolerance atol = rtol = 2e-4 (tests/test_goldens.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tpufusion.core.dtypes import Policy as JPolicy
from tpufusion.models import create_generator
from tpufusion_torch.fusion.arithmetic import arithmetic_fusion
from tpufusion_torch.fusion.drawer import FusionDrawer
from tpufusion_torch.io.convert import generator_state_from_jax, state_dict_to_torch
from tpufusion_torch.models.stylegan2 import Generator

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
TOL = dict(atol=2e-4, rtol=2e-4)


def _port_generator(variables, size, channel_multiplier=1):
    g = Generator(size, channel_multiplier=channel_multiplier, device="cpu")
    sd = generator_state_from_jax(jax.tree.map(np.asarray, variables), size,
                                  channel_multiplier)
    g.load_state_dict(state_dict_to_torch(sd))
    return g.requires_grad_(False)


@pytest.fixture(scope="module")
def jax_gen32():
    gen, variables = create_generator(32, jax.random.key(42), channel_multiplier=1,
                                      policy=JPolicy())
    return gen, variables, _port_generator(variables, 32)


class TestGenerator:
    def test_golden_32_seed42(self, jax_gen32):
        _, _, g = jax_gen32
        with np.load(os.path.join(GOLDEN_DIR, "generator_32_seed42.npz")) as f:
            golden, z = f["image"], f["z"]
        with torch.no_grad():
            img = g(torch.from_numpy(z)).image
        assert img.dtype == torch.float32
        np.testing.assert_allclose(img.numpy(), golden, **TOL)

    def test_truncation_mixing_latents_and_features_match_jax(self, jax_gen32):
        gen, variables, g = jax_gen32
        rng = np.random.default_rng(3)
        z1, z2 = (rng.standard_normal((2, 512)).astype(np.float32) for _ in range(2))
        tl = rng.standard_normal((1, 512)).astype(np.float32)
        out_j = jax.jit(lambda v, a, b, t: gen.apply(
            v, [a, b], truncation=0.7, truncation_latent=t, inject_index=3,
            return_latents=True))(variables, z1, z2, tl)
        with torch.no_grad():
            out_t = g([torch.from_numpy(z1), torch.from_numpy(z2)], truncation=0.7,
                      truncation_latent=torch.from_numpy(tl), inject_index=3,
                      return_latents=True)
        np.testing.assert_allclose(out_t.image.numpy(), np.asarray(out_j.image), **TOL)
        np.testing.assert_allclose(out_t.latents.numpy(), np.asarray(out_j.latents), **TOL)
        assert len(out_t.features) == len(out_j.features) == g.log_size - 1
        for ft, fj in zip(out_t.features, out_j.features):
            np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)

    def test_folded_up_convs_hold_the_synthesis_to_jax(self, jax_gen32, monkeypatch):
        """The synthesis with its up convs folded (the bf16 path, here in
        float32) and unfolded (transposed conv and blur: the float32 path)
        both match JAX's image and features at TOL, and each other at 1e-5
        of the largest entry."""
        from tpufusion_torch.ops import styled_conv as sc
        from tpufusion_torch.ops.modconv import modulated_conv2d_up_folded

        def folded(x, weight, style, noise, noise_strength, bias):
            y = modulated_conv2d_up_folded(x, weight, style, blur_taps=sc.UP_TAPS)
            return sc.noise_bias_act(y, noise, noise_strength, bias)

        gen, variables, g = jax_gen32
        z = np.random.default_rng(11).standard_normal((2, 512)).astype(np.float32)
        out_j = jax.jit(lambda v, a: gen.apply(v, [a]))(variables, z)
        outs = []
        for reference in (folded, sc.styled_conv_up_plain):
            monkeypatch.setattr(sc, "styled_conv_up_reference", reference)
            with torch.no_grad():
                out = g(torch.from_numpy(z))
            np.testing.assert_allclose(out.image.numpy(), np.asarray(out_j.image), **TOL)
            for ft, fj in zip(out.features, out_j.features):
                np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)
            outs.append([out.image, *out.features])
        for a, b in zip(*outs):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()

    def test_style_vector_round_trip_is_bit_exact(self, jax_gen32):
        _, _, g = jax_gen32
        z = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 512))
                             .astype(np.float32))
        with torch.no_grad():
            s = g(z, return_style_vector=True)
            a = g(z).image
            b = g(style_vector=s).image
        assert len(s) == g.n_styles == len(g.conv_plan())
        assert [tuple(t.shape) for t in s] == [(2, cin) for cin, _, _ in g.conv_plan()]
        assert torch.equal(a, b)

    def test_mean_latent_and_noise(self, jax_gen32):
        _, _, g = jax_gen32
        m = g.mean_latent(16, generator=torch.Generator().manual_seed(0))
        assert tuple(m.shape) == (1, 512) and m.dtype == torch.float32
        with pytest.raises(ValueError, match="noise_generator"):
            g(torch.zeros(1, 512), randomize_noise=True)
        with torch.no_grad():
            fixed = g(torch.zeros(1, 512)).image
            again = g(torch.zeros(1, 512)).image
        assert torch.equal(fixed, again)  # noise buffers are loaded, never redrawn

    def test_randomize_noise_draws_per_sample_noise(self, jax_gen32):
        _, variables, _ = jax_gen32
        g = _port_generator(variables, 32)
        with torch.no_grad():
            for layer in [g.conv1] + list(g.convs):
                layer.noise.weight.fill_(0.5)
            z = torch.zeros(2, 512)
            fixed = g(z).image
            rnd = g(z, randomize_noise=True,
                    noise_generator=torch.Generator().manual_seed(0)).image
        assert rnd.shape == fixed.shape and torch.isfinite(rnd).all()
        assert not torch.equal(rnd[0], rnd[1])  # per-sample planes
        assert torch.equal(fixed[0], fixed[1])  # one shared buffer per layer


@pytest.fixture(scope="module")
def drawers():
    """The JAX drawer of the fusion goldens (tests/test_goldens.py) and the
    port's drawer on its weights."""
    from tpufusion.fusion.drawer import FusionDrawer as JDrawer

    jd = JDrawer.create("ffhq", jax.random.key(7), size=32, channel_multiplier=1,
                        mean_latent_samples=8)
    return jd, FusionDrawer("ffhq", _port_generator(jd.gen_vars, 32),
                            torch.from_numpy(np.array(jd.mean_latent)))


class TestArithmeticFusionGolden:
    def test_fusion_ffhq_32_seed7(self, drawers):
        _, drawer = drawers
        with np.load(os.path.join(GOLDEN_DIR, "fusion_ffhq_32_seed7.npz")) as f:
            w, golden_ar, golden_singles = f["w"], f["fused_arith"], f["singles"]
        with torch.no_grad():
            fused, singles, feat = arithmetic_fusion(drawer, torch.from_numpy(w))
        np.testing.assert_allclose(fused.numpy(), golden_ar, **TOL)
        np.testing.assert_allclose(singles.numpy(), golden_singles, **TOL)
        assert tuple(feat.shape) == (w.shape[0], 32, 32, 512)

    def test_drawer_truncated_w_plus_to_s_matches_jax(self, drawers):
        jd, drawer = drawers
        w = np.random.default_rng(5).standard_normal((2, 8, 512)).astype(np.float32)
        s_j = jd.w_plus_to_s(jnp.asarray(w), truncation=0.5)
        with torch.no_grad():
            s_t = drawer.w_plus_to_s(torch.from_numpy(w), truncation=0.5)
        for a, b in zip(s_t, s_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

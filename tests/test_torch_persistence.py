"""Pipeline persistence across the two packages, CPU, float32, on the 32^2
test pipelines (``create_test_pipeline`` of each package).

- a directory the JAX package's ``FusionPipeline.save`` wrote loads in the
  port and gives JAX's fused image, both fusion modes, to 2e-4;
- a directory the port's ``save`` wrote loads in the JAX package and gives
  the port's fused image, to 2e-4; in the port it loads bit-identical;
- the two packages write the same ``pipeline.json`` and the same
  ``.npz`` keys and shapes for their test pipelines;
- each ``*_state_to_jax`` inverts its ``*_state_from_jax`` exactly;
- ``save_pytree`` / ``load_pytree`` read each other's files and add the
  ``.npz`` suffix as JAX's do;
- the checkpoint loaders: a rosinality ``g_ema`` checkpoint, an e4e
  checkpoint (``encoder.`` prefix, ``latent_avg``) and a torchvision-layout
  VGG16 (positional) give the JAX converters' outputs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import np_tree, one_torch_thread  # noqa: F401
from tpufusion.attacks.fusion_attack import make_fused_image_fn as j_fused_fn
from tpufusion.io import params_io as j_params_io
from tpufusion.io.checkpoint import convert_vgg16_checkpoint
from tpufusion.pipeline import FusionPipeline as JFusionPipeline
from tpufusion.pipeline import create_test_pipeline as j_create_test_pipeline
from tpufusion_torch.attacks.fusion_attack import make_fused_image_fn
from tpufusion_torch.io import convert
from tpufusion_torch.io import params_io as t_params_io
from tpufusion_torch.io.checkpoint import (
    load_e4e_checkpoint,
    load_stylegan2_checkpoint,
    load_torch_state_dict,
    load_vgg16_checkpoint,
)
from tpufusion_torch.pipeline import FusionPipeline, create_test_pipeline

TOL = dict(atol=2e-4, rtol=2e-4)
MODES = ("arithmetic", "spatial")
FILES = ("generator.npz", "encoder.npz", "vgg.npz", "fusion_nets.npz", "latents.npz")


@pytest.fixture(scope="module")
def inputs():
    return np.random.default_rng(41).uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A JAX-saved and a port-saved directory, and the pipelines saved."""
    root = tmp_path_factory.mktemp("pipelines")
    jp = j_create_test_pipeline("ffhq", jax.random.key(0), size=32)
    jp.save(str(root / "jax"))
    tp = create_test_pipeline(device="cpu", seed=1)
    tp.save(str(root / "port"))
    return jp, str(root / "jax"), tp, str(root / "port")


def _j_fused(jp, mode, x):
    params = dict(enc=jp.enc_vars, gen=jp.drawer.gen_vars, blend=jp.drawer.blend_params,
                  vgg=jp.vgg_vars)
    return np.asarray(jax.jit(j_fused_fn(jp, mode))(params, jnp.asarray(x)))


def _t_fused(tp, mode, x):
    with torch.no_grad():
        return make_fused_image_fn(tp, mode)(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("mode", MODES)
def test_jax_save_loads_in_the_port(mode, dirs, inputs):
    jp, jdir, _, _ = dirs
    tp = FusionPipeline.load(jdir, device="cpu")
    x = inputs if mode == "spatial" else inputs[:2]
    np.testing.assert_allclose(_t_fused(tp, mode, x), _j_fused(jp, mode, x), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_port_save_loads_in_jax(mode, dirs, inputs):
    _, _, tp, tdir = dirs
    jp = JFusionPipeline.load(tdir)
    x = inputs if mode == "spatial" else inputs[:2]
    np.testing.assert_allclose(_j_fused(jp, mode, x), _t_fused(tp, mode, x), **TOL)


def test_port_round_trip_is_bit_identical(dirs, inputs, tmp_path):
    _, _, tp, tdir = dirs
    back = FusionPipeline.load(tdir, device="cpu")
    for name in ("generator", "encoder", "vgg"):
        want, got = getattr(tp, name).state_dict(), getattr(back, name).state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    assert torch.equal(back.latent_avg, tp.latent_avg)
    assert torch.equal(back.drawer.mean_latent, tp.drawer.mean_latent)
    assert not any(p.requires_grad for p in back.generator.parameters())
    for mode in MODES:
        x = inputs if mode == "spatial" else inputs[:2]
        np.testing.assert_array_equal(_t_fused(back, mode, x), _t_fused(tp, mode, x))
    # saved again, the files are the same
    back.save(str(tmp_path / "again"))
    for f in FILES:
        a, b = t_params_io.load_pytree(os.path.join(tdir, f)), \
            t_params_io.load_pytree(str(tmp_path / "again" / f))
        jax.tree.map(np.testing.assert_array_equal, a, b)


def test_both_packages_write_the_same_layout(dirs):
    _, jdir, _, tdir = dirs
    metas = [json.load(open(os.path.join(d, "pipeline.json"))) for d in (jdir, tdir)]
    assert metas[0] == metas[1]
    assert metas[0]["encoder_units"] == [1, 1, 1, 1] and metas[0]["size"] == 32
    for f in FILES:
        with np.load(os.path.join(jdir, f)) as a, np.load(os.path.join(tdir, f)) as b:
            assert {k: a[k].shape for k in a} == {k: b[k].shape for k in b}, f


def test_state_to_jax_inverts_state_from_jax(dirs):
    jp = dirs[0]
    gen = np_tree(jp.drawer.gen_vars)
    pairs = [
        (gen, convert.generator_state_to_jax(convert.generator_state_from_jax(gen, 32, 1), 32)),
        (np_tree(jp.enc_vars), convert.encoder_state_to_jax(
            convert.encoder_state_from_jax(np_tree(jp.enc_vars), (1, 1, 1, 1)), (1, 1, 1, 1))),
        (np_tree(jp.vgg_vars), convert.vgg_state_to_jax(
            convert.vgg_state_from_jax(np_tree(jp.vgg_vars)))),
        (np_tree(jp.drawer.blend_params), convert.blender_state_to_jax(
            convert.blender_state_from_jax(np_tree(jp.drawer.blend_params)))),
    ]
    for want, got in pairs:
        assert jax.tree.structure(got) == jax.tree.structure(want)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), got, want)


def test_params_io_reads_the_other_package(tmp_path):
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "c": np.asarray(True), "d": torch.ones(2)}
    path = t_params_io.save_pytree(tree, str(tmp_path / "port"))
    assert path.endswith("port.npz") and os.path.exists(path)
    back = j_params_io.load_pytree(path)
    np.testing.assert_array_equal(np.asarray(back["a"]["b"]), tree["a"]["b"])
    jpath = j_params_io.save_pytree({"x": {"y": np.ones(3)}}, str(tmp_path / "jax.npz"))
    assert t_params_io.load_pytree(jpath) == {"x": {"y": pytest.approx(np.ones(3))}}
    assert isinstance(t_params_io.load_pytree(path)["d"], np.ndarray)


def test_create_test_pipeline_is_jax_sized():
    tp = create_test_pipeline(device="cpu")
    assert (tp.image_size, tp.generator.channel_multiplier, tp.encoder.base_channels,
            tp.encoder.unit_counts, tp.encoder_input_size) == (32, 1, 16, (1, 1, 1, 1), 32)
    assert tp.policy.compute_dtype == torch.float32


def test_checkpoint_loaders_match_jax_converters(dirs, tmp_path, inputs):
    """rosinality ``g_ema`` and e4e checkpoints (written here from the JAX
    test pipeline's weights) load by name into the port's modules; a
    torchvision ``features.N`` VGG16 loads by position as JAX converts it."""
    jp = dirs[0]
    tp = create_test_pipeline(device="cpu", seed=5)
    g_sd = convert.generator_state_from_jax(np_tree(jp.drawer.gen_vars), 32, 1)
    torch.save({"g_ema": {k: torch.tensor(v) for k, v in g_sd.items()}},
               str(tmp_path / "g.pt"))
    e_sd = convert.encoder_state_from_jax(np_tree(jp.enc_vars), (1, 1, 1, 1))
    ckpt = {"state_dict": {**{f"encoder.{k}": torch.tensor(v) for k, v in e_sd.items()},
                           **{f"decoder.{k}": torch.tensor(v) for k, v in g_sd.items()}},
            "latent_avg": torch.tensor(np.asarray(jp.latent_avg)), "opts": {}}
    torch.save(ckpt, str(tmp_path / "e4e.pt"))
    load_stylegan2_checkpoint(load_torch_state_dict(str(tmp_path / "g.pt")), tp.generator)
    tp.latent_avg = load_e4e_checkpoint(load_torch_state_dict(str(tmp_path / "e4e.pt")),
                                        tp.encoder)
    tp.drawer.mean_latent = torch.tensor(np.asarray(jp.drawer.mean_latent))
    x = inputs[:2]
    np.testing.assert_allclose(_t_fused(tp, "arithmetic", x), _j_fused(jp, "arithmetic", x),
                               **TOL)
    # torchvision layout: features.{0,2,5,...}, then layers the taps never use
    rng = np.random.default_rng(3)
    shapes = [(64, 3), (64, 64), (128, 64), (128, 128), (256, 128), (256, 256), (256, 256),
              (512, 256), (512, 512), (512, 512)]
    vgg_sd = {}
    for i, (o, c) in enumerate(shapes):
        vgg_sd[f"features.{i}.weight"] = (rng.standard_normal((o, c, 3, 3)) * 0.05
                                          ).astype(np.float32)
        vgg_sd[f"features.{i}.bias"] = rng.standard_normal(o).astype(np.float32) * 0.1
    load_vgg16_checkpoint(vgg_sd, tp.vgg)
    jvars = jax.tree.map(jnp.asarray, convert_vgg16_checkpoint(vgg_sd))
    want = jax.jit(jp.vgg.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = tp.vgg(torch.from_numpy(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4 * np.abs(b).max(),
                                   rtol=0)

"""The port stands alone and never hides the device.

- ``tpufusion_torch`` and every submodule import without ``jax`` or any
  ``tpufusion.*`` module (checked in a fresh interpreter), and no source file
  of the port, nor ``chip_smoke.py``, imports them;
- entry points called without ``device=`` (the CLIs without ``--device
  cpu``) on a machine with no CUDA raise;
- the kernel wrappers take their plain versions only for CPU tensors: given a
  tensor on another device they launch the kernel or raise, here with the
  library loader made to fail.
"""

import os
import pkgutil
import re
import subprocess
import sys
import types

import pytest
import torch

from tpufusion_torch.ops import _lib
from tpufusion_torch.ops import adam_update as au
from tpufusion_torch.ops import conv3x3 as c3
from tpufusion_torch.ops import pgd_update as pu
from tpufusion_torch.ops import styled_conv as sc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpufusion_torch")
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|tpufusion)(\.|\s|$)", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], "tpufusion_torch."))


def test_imports_pull_in_no_jax_and_no_tpufusion():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tpufusion' or m.startswith('tpufusion.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert len(_modules()) >= 20


@pytest.mark.parametrize("path", ["tpufusion_torch", "chip_smoke.py"])
def test_sources_import_no_jax_and_no_tpufusion(path):
    full = os.path.join(ROOT, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs if f.endswith(".py")]
    assert files
    for f in files:
        with open(f) as fh:
            src = fh.read()
        assert not FORBIDDEN.search(src), f


def test_entry_points_raise_without_cuda(monkeypatch):
    import numpy as np

    from tpufusion_torch import eval as ev
    from tpufusion_torch.core.dtypes import resolve_device
    from tpufusion_torch.fusion.drawer import FusionDrawer
    from tpufusion_torch.models.e4e import Encoder4Editing
    from tpufusion_torch.core.prng import PRNGPool, seed_everything
    from tpufusion_torch.models.fusion_hierarchy import HierarchyBlender
    from tpufusion_torch.models.lpips import LPIPS, load_torch_lpips
    from tpufusion_torch.models.classifiers import create_vit_classifier, load_gender_classifier
    from tpufusion_torch.models.discriminator import create_discriminator
    from tpufusion_torch.models.resnet import create_resnet18
    from tpufusion_torch.models.stylegan2 import Generator
    from tpufusion_torch.models.vgg16 import VGG16
    from tpufusion_torch.models.vit import create_vit
    from tpufusion_torch.pipeline import FusionPipeline, create_test_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((1, 8, 8, 3), np.float32)
    lat = np.zeros((5, 8, 512), np.float32)
    on_card = types.SimpleNamespace(device=torch.device("cuda"), dataset="ffhq")
    for build in (lambda: FusionPipeline.create("ffhq", size=32, channel_multiplier=1),
                  lambda: FusionDrawer.create("ffhq", size=32, channel_multiplier=1),
                  lambda: Generator(32, channel_multiplier=1),
                  lambda: Encoder4Editing(8, base_channels=16, unit_counts=(1, 1, 1, 1),
                                          input_size=32),
                  lambda: VGG16(),
                  lambda: HierarchyBlender("ffhq", [512] * 26),
                  lambda: LPIPS(),
                  lambda: PRNGPool(),
                  lambda: seed_everything(),
                  lambda: create_resnet18(),
                  lambda: load_gender_classifier(None),
                  lambda: create_vit(8, image_size=32, patch_size=8, hidden_size=32,
                                     num_layers=1, num_heads=2, intermediate_size=64),
                  lambda: create_vit_classifier(8, image_size=32, patch_size=8,
                                                hidden_size=32, num_layers=1, num_heads=2,
                                                intermediate_size=64),
                  lambda: create_discriminator(32, channel_multiplier=1),
                  lambda: create_test_pipeline(),
                  # before it reads the directory
                  lambda: FusionPipeline.load("no-such-directory"),
                  # the eval entry points run arrays on the card unless asked
                  lambda: ev.mse_per_image(img, img),
                  lambda: ev.input_noise_mse(img, img),
                  lambda: ev.ssim(img, img),
                  lambda: ev.rgb_to_gray(img),
                  lambda: ev.latent_distance(np.zeros((8, 512)), np.zeros((1, 8, 512))),
                  # ... and on the device of the drawer or pipeline they are given
                  lambda: ev.partial_adv_fusion(on_card, lat, lat),
                  lambda: ev.benign_fusion(on_card, lat),
                  lambda: ev.fused_image_metrics(types.SimpleNamespace(generator=on_card),
                                                 img, img)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    # the checkpoint loader builds its network on the card unless asked
    monkeypatch.setattr(torch, "load", lambda *a, **k: {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_torch_lpips("lpips.pth")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_cli_and_loader_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The landmark net, the alignment hook, the runner's loaders and the
    three CLIs run on the card unless asked: without one they raise before
    they read or write anything."""
    from tpufusion_torch.cli import attack_run, fuse, invert
    from tpufusion_torch.data.alignment import resolve_align_preprocess
    from tpufusion_torch.models import landmarks
    from tpufusion_torch.runner import load_existing_inputs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    weights = os.path.join(landmarks.WEIGHTS_DIR, "landmark_net.npz")
    for build in (lambda: landmarks.create_landmark_net(),
                  lambda: landmarks.load_landmark_net(weights),
                  lambda: landmarks.load_packaged_landmark_net(),
                  lambda: landmarks.packaged_landmark_provider(),
                  lambda: resolve_align_preprocess(None, None),
                  lambda: resolve_align_preprocess(weights, None),
                  lambda: load_existing_inputs("no-such-file.npz", 5, 32),
                  lambda: attack_run.main(["--tiny", "--save_dir", str(tmp_path / "runs")]),
                  lambda: invert.main(["--images_dir", str(tmp_path), "--tiny",
                                       "--save_dir", str(tmp_path / "inv")]),
                  lambda: fuse.main(["--tiny", "--out", str(tmp_path / "demo.jpg")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert os.listdir(tmp_path) == []


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_wrappers_raise_off_cpu_when_library_is_missing(monkeypatch):
    def missing(name):
        raise RuntimeError(f"lib{name}.so unavailable")

    monkeypatch.setattr(_lib, "load", missing)
    x = _meta(1, 8, 8, 32)
    styled_args = (x, _meta(3, 3, 32, 32), _meta(1, 32), _meta(1, 8, 8, 1), _meta(), _meta(32))
    # every wrapper refuses a tensor off the card before it loads
    with pytest.raises(ValueError, match="CUDA"):
        c3.conv3x3(x, _meta(3, 3, 32, 32))
    with pytest.raises(ValueError, match="CUDA"):
        sc.styled_conv(*styled_args)
    with pytest.raises(ValueError, match="contiguous CUDA tensor"):
        pu.pgd_update(x, x, x, 0.1, 0.1)
    with pytest.raises(ValueError, match="contiguous CUDA tensor"):
        au.fused_adam(x, x, au.adam_init(x), 0.1)
    # past those checks, a tensor off the CPU reaches the loader and raises
    # with it: no fallback to the plain version
    monkeypatch.setattr(c3, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(sc, "_check_cuda", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        c3.conv3x3(x, _meta(3, 3, 32, 32))
    with pytest.raises(RuntimeError, match="unavailable"):
        sc.styled_conv(*styled_args)
    monkeypatch.setattr(pu, "_check_cuda", lambda name, t: None)
    monkeypatch.setattr(au, "_check_cuda", lambda name, t: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        pu.pgd_update(x, x, x, 0.1, 0.1)
    with pytest.raises(RuntimeError, match="unavailable"):
        au.fused_adam(x, x, au.adam_init(x), 0.1)
    # CPU tensors never reach the loader
    t = torch.zeros(1, 8, 8, 32)
    assert c3.conv3x3(t, torch.zeros(3, 3, 32, 32)).shape == t.shape
    assert pu.pgd_update(t, t, t, 0.1, 0.1).shape == t.shape
    assert au.fused_adam(t, t, au.adam_init(t), 0.1)[0] is t


def test_stream_handle_falls_back_to_the_public_call(monkeypatch):
    """Where PyTorch lacks its private raw-stream binding, the launch helper
    reads the same handle through ``torch.cuda.current_stream``."""
    monkeypatch.setattr(_lib, "_raw_stream", None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index: types.SimpleNamespace(cuda_stream=1234 + index))
    assert _lib.current_stream_handle(1) == 1235
    monkeypatch.setattr(_lib, "_raw_stream", lambda index: 7 + index)
    assert _lib.current_stream_handle(1) == 8


def test_fused_adam_kernel_takes_float32_only(monkeypatch):
    """The pixel buffer and its moments are float32 under every policy: the
    kernel wrapper refuses another dtype before it launches."""
    monkeypatch.setattr(_lib, "load", lambda name: types.SimpleNamespace(tf_adam_update=None))
    x = torch.empty((2, 3), dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="float32"):
        au.adam_update_kernel(x, x, x, x, 0.1, 0.1, 0.1)


def test_loader_raises_when_nvcc_cannot_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_lib, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_lib, "_LIBS", {})
    with pytest.raises(OSError):
        _lib.load("pgd_update")

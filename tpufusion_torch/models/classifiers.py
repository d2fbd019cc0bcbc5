"""Classifier adapters for the classifier-transfer attacks (port of
``tpufusion/models/classifiers.py``).

The reference attacks two external classifiers with PGD and CW:
- FFHQ: a torchvision resnet18 gender model (`interpolation.py:1296-1302`)
  -> ``models.resnet``;
- cars: the ``stanford-car-vit-patch16`` HF ViT (`interpolation.py:1294,1355`)
  -> ``models.vit`` (the native backend; the JAX package's transformers
  Flax adapter has no counterpart here).

Each adapter gives ``logits_fn(model, images_nhwc_pm1) -> (B, K)`` for
``attacks.pgd.make_pgd`` / ``attacks.cw.make_cw``. The model is an explicit
argument, as the JAX adapters take their parameters. Inputs are NHWC in
[-1, 1]; the resize to the classifier's input size happens inside the
differentiated function (the reference resizes to 224 before attacking,
`interpolation.py:1361-1365`).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from tpufusion_torch.core.imaging import resize_bilinear
from tpufusion_torch.io.checkpoint import load_named_state, load_torch_state_dict
from tpufusion_torch.models.resnet import create_resnet18
from tpufusion_torch.models.vit import create_vit


def _resized_logits(size: int) -> Callable:
    def logits(model, images):
        x = images
        if x.shape[1] != size:
            x = resize_bilinear(x, size, size)
        return model(x)

    return logits


def resnet_logits_fn(input_size: int = 256) -> Callable:
    """Gender-classifier adapter (ffhq): ``logits(model, images) -> (B, 2)``,
    images resized to ``input_size`` first."""
    return _resized_logits(input_size)


def resolve_vit_backend(pretrained_dir: Optional[str]) -> str:
    """``backend='auto'`` rule: native unless ``pretrained_dir`` holds ONLY
    flax-serialized weights (``flax_model.msgpack`` with no
    ``pytorch_model.bin``/``model.safetensors``) — those dirs loaded fine
    through the flax adapter before the native backend existed and must
    keep working."""
    if pretrained_dir:
        has_torch = any(
            os.path.exists(os.path.join(pretrained_dir, n))
            for n in ("pytorch_model.bin", "model.safetensors"))
        if not has_torch and os.path.exists(
                os.path.join(pretrained_dir, "flax_model.msgpack")):
            return "flax_hf"
    return "native"


def create_vit_classifier(
    num_labels: int,
    *,
    image_size: int = 224,
    patch_size: int = 16,
    hidden_size: int = 768,
    num_layers: int = 12,
    num_heads: int = 12,
    intermediate_size: int = 3072,
    pretrained_dir: Optional[str] = None,
    seed: int = 0,
    backend: str = "auto",
    policy=None,
    device=None,
):
    """Build (or load) the cars ViT classifier (vit-patch16 @224) on
    ``device`` (``cuda`` unless given). ``pretrained_dir`` is a locally
    downloaded HF model dir; its ``pytorch_model.bin``, else its
    ``model.safetensors``, is read with ``torch.load`` and loaded by name.
    ``backend='flax_hf'`` (picked by ``'auto'`` for a dir that holds only
    ``flax_model.msgpack``) raises: the port has no Flax adapter.

    Returns ``(logits_fn, model)`` with
    ``logits_fn(model, images_nhwc_pm1) -> (B, num_labels)``.
    """
    if backend == "auto":
        backend = resolve_vit_backend(pretrained_dir)
    if backend == "flax_hf":
        raise ValueError(
            "ViT backend 'flax_hf' (transformers' Flax adapter) has no counterpart in "
            "tpufusion_torch; give a dir with pytorch_model.bin or model.safetensors")
    if backend != "native":
        raise ValueError(f"unknown ViT backend {backend!r}")
    state = None
    if pretrained_dir:
        for name in ("pytorch_model.bin", "model.safetensors"):
            p = os.path.join(pretrained_dir, name)
            if os.path.exists(p):
                state = load_torch_state_dict(p)
                break
        if state is None:
            raise FileNotFoundError(
                f"{pretrained_dir}: no pytorch_model.bin / "
                "model.safetensors (use backend='flax_hf' for "
                "flax-serialized HF dirs)")
    model = create_vit(num_labels, policy=policy, device=device, seed=seed,
                       image_size=image_size, patch_size=patch_size,
                       hidden_size=hidden_size, num_layers=num_layers,
                       num_heads=num_heads, intermediate_size=intermediate_size)
    if state is not None:
        load_named_state(model, state)
    return _resized_logits(model.image_size), model


def load_gender_classifier(checkpoint_path: Optional[str], *, policy=None, device=None,
                           seed: int = 0):
    """The FFHQ gender model: a resnet18 with a 2-way head
    (`interpolation.py:1296-1302`) on ``device`` (``cuda`` unless given),
    seeded random weights when there is no checkpoint. Returns
    ``(logits_fn, model)``."""
    model = create_resnet18(2, policy=policy, device=device, seed=seed)
    if checkpoint_path:
        load_named_state(model, load_torch_state_dict(checkpoint_path))
    return resnet_logits_fn(), model

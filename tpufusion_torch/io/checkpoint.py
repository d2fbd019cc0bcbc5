"""PyTorch checkpoints -> the port's modules (port of
``tpufusion/io/checkpoint.py``).

The JAX package converts each external checkpoint into its own layout. The
port's modules carry the checkpoints' own state-dict names, so here the
converters become loaders:

- a rosinality StyleGAN2 ``g_ema`` loads by name into ``Generator``;
- an e4e checkpoint (``state_dict`` + ``latent_avg``) loads its
  ``encoder.``-prefixed entries into ``Encoder4Editing``;
- ``imagenet_vgg16.pth`` maps by position onto the nine convs of ``VGG16``
  (the reference maps parameter-name lists index by index, `vgg.py:66-76`);
- a torchvision resnet18 and an HF ViT load by name.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# the convs the VGG16 taps use, in checkpoint order
_VGG_LAYERS = [
    "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
    "conv3_3", "conv4_1", "conv4_2",
]


def load_torch_state_dict(path: str) -> dict:
    """Load a .pt/.pth pickle into a {name: np.ndarray} dict (non-tensor
    entries passed through)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return to_numpy_tree(obj)


def to_numpy_tree(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, Mapping):
        return {k: to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy_tree(v) for v in obj)
    return obj


def load_named_state(module: torch.nn.Module, state: Mapping) -> torch.nn.Module:
    """Load ``{name: array or tensor}`` into ``module`` by name, each entry
    cast to its parameter's dtype and device and reshaped to its shape.
    Entries the module lacks are ignored, as the JAX converters read only
    the names they need; a name the module holds and ``state`` lacks
    raises ``KeyError``, except batch norm's ``num_batches_tracked``
    counters, which the forward never reads."""
    own = module.state_dict()
    missing = [k for k in own if k not in state and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} of the module's entries: "
                       f"{missing[:5]}")
    with torch.no_grad():
        for name, dst in own.items():
            if name in state:
                src = state[name]
                if not isinstance(src, torch.Tensor):
                    src = torch.as_tensor(np.asarray(src))
                dst.copy_(src.reshape(dst.shape))
    return module


def load_stylegan2_checkpoint(state: Mapping, generator) -> torch.nn.Module:
    """A rosinality checkpoint (``{"g_ema": ...}``) or its ``g_ema`` state
    dict -> ``generator``."""
    return load_named_state(generator, state["g_ema"] if "g_ema" in state else state)


def load_e4e_checkpoint(ckpt: Mapping, encoder):
    """An e4e ``{state_dict, latent_avg, opts}`` -> ``encoder``; returns
    ``latent_avg`` as a float32 tensor on the encoder's device, or None.
    Only ``encoder.``-prefixed entries are read (all of them when none
    carries the prefix); the decoder half is a rosinality generator
    (``load_stylegan2_checkpoint`` on its ``decoder.`` entries)."""
    full = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    sd = {k[len("encoder."):]: v for k, v in full.items() if k.startswith("encoder.")}
    load_named_state(encoder, sd or full)
    if "latent_avg" not in ckpt:
        return None
    device = next(encoder.parameters()).device
    return torch.as_tensor(np.asarray(ckpt["latent_avg"]), dtype=torch.float32, device=device)


def load_vgg16_checkpoint(state: Mapping, vgg) -> torch.nn.Module:
    """A pretrained VGG16 state dict -> ``vgg``'s nine convs, by position:
    the (weight, bias) pairs in checkpoint order. Works for torchvision's
    ``features.N`` layout and the reference's conv-named layout alike."""
    tensors = list(state.values())
    named = {}
    for i, name in enumerate(_VGG_LAYERS):
        named[f"{name}.weight"], named[f"{name}.bias"] = tensors[2 * i], tensors[2 * i + 1]
    return load_named_state(vgg, named)

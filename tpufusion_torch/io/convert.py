"""JAX-package variables -> this package's state dicts.

The inverse of the JAX package's checkpoint converters
(``tpufusion/io/checkpoint.py::convert_stylegan2_checkpoint``,
``::convert_e4e_checkpoint`` and the VGG16 loader), written from their layouts
without importing them. Inputs are the JAX variables as nested dicts of numpy arrays; outputs
are ``{name: np.ndarray}`` dicts with rosinality / e4e names, ready for
``load_state_dict`` after ``torch.from_numpy``.

  flax conv kernel (kh, kw, in, out)   -> torch conv (out, in, kh, kw)
  flax dense kernel (in, out)          -> torch linear (out, in)
  generator w_i (k, k, in, out)        -> modconv (1, out, in, k, k)
  noise (1, H, W, 1)                   -> (1, 1, H, W)
  scanned units / vmapped heads        -> one entry per unit / head
"""

from __future__ import annotations

import numpy as np
import torch

from tpufusion_torch.models.fusion_hierarchy import fusion_net_state_from_jax
from tpufusion_torch.ops.upfirdn2d import _kernel_2d


def _conv(k):  # HWIO -> OIHW
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _linear(k):  # (in, out) -> (out, in)
    return np.ascontiguousarray(np.transpose(np.asarray(k), (1, 0)))


def _module_names(log_size: int):
    names = ["conv1", "to_rgb1"]
    for i in range(log_size - 2):
        names += [f"convs.{2 * i}", f"convs.{2 * i + 1}", f"to_rgbs.{i}"]
    return names


def _kinds(log_size: int):
    kinds = ["conv", "rgb"]
    for _ in range(log_size - 2):
        kinds += ["up", "conv", "rgb"]
    return kinds


def generator_state_from_jax(variables_np: dict, size: int, channel_multiplier: int = 2,
                             blur_taps=(1, 3, 3, 1)) -> dict:
    """JAX ``Generator`` variables -> rosinality ``g_ema`` state dict.
    ``channel_multiplier`` is implied by the weight shapes and kept for
    symmetry with the generator's constructor."""
    del channel_multiplier
    p = variables_np["params"]
    log_size = int(np.log2(size))
    sd = {}
    mapping = p["mapping"]
    for i in range(len(mapping)):
        sd[f"style.{i + 1}.weight"] = _linear(mapping[f"fc{i}"]["kernel"])
        sd[f"style.{i + 1}.bias"] = np.asarray(mapping[f"fc{i}"]["bias"])
    sd["input.input"] = np.ascontiguousarray(np.transpose(p["input_const"], (0, 3, 1, 2)))
    fir = _kernel_2d(tuple(blur_taps), 4.0)
    noise_idx = 0
    for j, (name, kind) in enumerate(zip(_module_names(log_size), _kinds(log_size))):
        sd[f"{name}.conv.weight"] = _conv(p[f"w{j}"])[None]
        sd[f"{name}.conv.modulation.weight"] = _linear(p[f"affine_{j}"]["kernel"])
        sd[f"{name}.conv.modulation.bias"] = np.asarray(p[f"affine_{j}"]["bias"])
        if kind == "rgb":
            sd[f"{name}.bias"] = np.asarray(p[f"b{j}"]).reshape(1, 3, 1, 1)
            if name != "to_rgb1":
                sd[f"{name}.upsample.kernel"] = fir.copy()
        else:
            sd[f"{name}.activate.bias"] = np.asarray(p[f"b{j}"]).reshape(-1)
            sd[f"{name}.noise.weight"] = np.asarray(p[f"ns{noise_idx}"]).reshape(1)
            noise_idx += 1
            if kind == "up":
                sd[f"{name}.conv.blur.kernel"] = fir.copy()
    for key, buf in variables_np.get("noise", {}).items():
        sd[f"noises.{key}"] = np.ascontiguousarray(np.transpose(buf, (0, 3, 1, 2)))
    return sd


def _bn(dst: dict, prefix: str, bn: dict):
    dst[f"{prefix}.weight"] = np.asarray(bn["scale"])
    dst[f"{prefix}.bias"] = np.asarray(bn["bias"])
    dst[f"{prefix}.running_mean"] = np.asarray(bn["mean"])
    dst[f"{prefix}.running_var"] = np.asarray(bn["var"])
    dst[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _unit(dst: dict, prefix: str, u: dict):
    _bn(dst, f"{prefix}.res_layer.0", u["bn1"])
    dst[f"{prefix}.res_layer.1.weight"] = _conv(u["conv1"]["kernel"])
    dst[f"{prefix}.res_layer.2.weight"] = np.asarray(u["prelu"]["alpha"])
    dst[f"{prefix}.res_layer.3.weight"] = _conv(u["conv2"]["kernel"])
    _bn(dst, f"{prefix}.res_layer.4", u["bn2"])
    for fc in ("fc1", "fc2"):
        dst[f"{prefix}.res_layer.5.{fc}.weight"] = _linear(u["se"][fc]["kernel"])[:, :, None, None]
    if "shortcut_conv" in u:
        dst[f"{prefix}.shortcut_layer.0.weight"] = _conv(u["shortcut_conv"]["kernel"])
        _bn(dst, f"{prefix}.shortcut_layer.1", u["shortcut_bn"])


def _index(tree, i):
    """Entry ``i`` of a tree stacked along a leading axis."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def encoder_state_from_jax(variables_np: dict, unit_counts) -> dict:
    """JAX ``Encoder4Editing`` variables -> e4e ``encoder.`` state dict
    (prefix stripped)."""
    p = variables_np["params"]
    sd = {"input_layer.0.weight": _conv(p["input_conv"]["kernel"])}
    _bn(sd, "input_layer.1", p["input_bn"])
    sd["input_layer.2.weight"] = np.asarray(p["input_prelu"]["alpha"])
    for name in ("latlayer1", "latlayer2", "c3_proj"):
        if name in p:
            sd[f"{name}.weight"] = _conv(p[name]["kernel"])
            sd[f"{name}.bias"] = np.asarray(p[name]["bias"])
    i = 0
    for s, n_units in enumerate(unit_counts):
        _unit(sd, f"body.{i}", p[f"stage{s}_unit0"])
        i += 1
        for u in range(n_units - 1):
            _unit(sd, f"body.{i}", _index(p[f"stage{s}_rest"]["block"], u))
            i += 1
    h = 0
    for group in ("heads_coarse", "heads_middle", "heads_fine"):
        if group not in p:
            continue
        stacked = p[group]
        for g in range(np.asarray(stacked["linear"]["kernel"]).shape[0]):
            head = _index(stacked, g)
            k = 0
            while f"conv{k}" in head:
                sd[f"styles.{h}.convs.{2 * k}.weight"] = _conv(head[f"conv{k}"]["kernel"])
                sd[f"styles.{h}.convs.{2 * k}.bias"] = np.asarray(head[f"conv{k}"]["bias"])
                k += 1
            sd[f"styles.{h}.linear.weight"] = _linear(head["linear"]["kernel"])
            sd[f"styles.{h}.linear.bias"] = np.asarray(head["linear"]["bias"])
            h += 1
    return sd


def vgg_state_from_jax(variables_np: dict) -> dict:
    """JAX ``VGG16`` variables -> ``conv*_*.{weight (OIHW), bias}``."""
    return {f"{name}.{k}": v
            for name, layer in variables_np["params"].items()
            for k, v in (("weight", _conv(layer["kernel"])), ("bias", np.asarray(layer["bias"])))}


def blender_state_from_jax(blend_params_np: dict) -> dict:
    """JAX ``HierarchyBlender`` params ``{node: {"params": {"gate{i}_fc{1,2}":
    {kernel, bias}}}}`` -> the port blender's state dict
    (``nets.{node}.gate{i}_fc{1,2}.{weight (out, in), bias}``)."""
    return {f"nets.{node}.{k}": v for node, p in blend_params_np.items()
            for k, v in fusion_net_state_from_jax(p).items()}


def state_dict_to_torch(sd: dict, device=None) -> dict:
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in sd.items()}

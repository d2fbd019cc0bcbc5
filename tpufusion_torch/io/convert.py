"""JAX-package variables <-> this package's state dicts.

``*_state_from_jax`` invert the JAX package's checkpoint converters
(``tpufusion/io/checkpoint.py::convert_stylegan2_checkpoint``,
``::convert_e4e_checkpoint``, the VGG16 loader, ``convert_ada_discriminator``,
``tpufusion/models/resnet.py::convert_resnet18_checkpoint``,
``tpufusion/models/vit.py::convert_vit_checkpoint`` and the flax layout of
``tpufusion/models/landmarks.py::LandmarkNet``), written from their
layouts without importing them: inputs are the JAX variables as nested dicts
of numpy arrays, outputs ``{name: np.ndarray}`` dicts with the port's names,
ready for ``load_state_dict`` after ``torch.from_numpy``. ``*_state_to_jax``
go the other way, from a state dict (tensors or arrays) to the JAX
variables, for ``FusionPipeline.save``.

  flax conv kernel (kh, kw, in, out)   -> torch conv (out, in, kh, kw)
  flax dense kernel (in, out)          -> torch linear (out, in)
  generator w_i (k, k, in, out)        -> modconv (1, out, in, k, k)
  noise (1, H, W, 1)                   -> (1, 1, H, W)
  scanned units / vmapped heads        -> one entry per unit / head
"""

from __future__ import annotations

import numpy as np
import torch

from tpufusion_torch.models.fusion_hierarchy import (
    fusion_net_state_from_jax,
    fusion_net_state_to_jax,
)
from tpufusion_torch.ops.upfirdn2d import _kernel_2d


def _conv(k):  # HWIO -> OIHW
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _linear(k):  # (in, out) -> (out, in)
    return np.ascontiguousarray(np.transpose(np.asarray(k), (1, 0)))


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _hwio(w):  # OIHW -> HWIO
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 1, 0)))


def _in_out(w):  # (out, in) -> (in, out)
    return np.ascontiguousarray(_np(w).T)


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


def lpips_state_from_jax(variables_np: dict) -> dict:
    """JAX ``LPIPS`` variables -> the port's ``LPIPS`` state dict:
    ``conv*_*.{weight (OIHW), bias}`` and the heads ``lin{i}`` (C, 1) ->
    (1, C, 1, 1)."""
    p = variables_np["params"]
    sd = vgg_state_from_jax({"params": {k: v for k, v in p.items() if not k.startswith("lin")}})
    for k, v in p.items():
        if k.startswith("lin"):
            sd[k] = np.asarray(v).reshape(1, -1, 1, 1)
    return sd


def blender_state_from_jax(blend_params_np: dict) -> dict:
    """JAX ``HierarchyBlender`` params ``{node: {"params": {"gate{i}_fc{1,2}":
    {kernel, bias}}}}`` -> the port blender's state dict
    (``nets.{node}.gate{i}_fc{1,2}.{weight (out, in), bias}``)."""
    return {f"nets.{node}.{k}": v for node, p in blend_params_np.items()
            for k, v in fusion_net_state_from_jax(p).items()}


def generator_state_to_jax(state: dict, size: int) -> dict:
    """rosinality ``g_ema`` state dict -> JAX ``Generator`` variables
    ``{"params", "noise"}`` (the FIR buffers are dropped: the JAX generator
    builds its taps)."""
    sd = {k: _np(v) for k, v in state.items()}
    log_size = int(np.log2(size))
    n_mlp = sum(1 for k in sd if k.startswith("style.") and k.endswith(".weight"))
    p: dict = {"mapping": {f"fc{i}": {"kernel": _in_out(sd[f"style.{i + 1}.weight"]),
                                      "bias": sd[f"style.{i + 1}.bias"]}
                           for i in range(n_mlp)},
               "input_const": np.ascontiguousarray(np.transpose(sd["input.input"],
                                                                (0, 2, 3, 1)))}
    noise_idx = 0
    for j, (name, kind) in enumerate(zip(_module_names(log_size), _kinds(log_size))):
        p[f"w{j}"] = _hwio(sd[f"{name}.conv.weight"][0])
        p[f"affine_{j}"] = {"kernel": _in_out(sd[f"{name}.conv.modulation.weight"]),
                            "bias": sd[f"{name}.conv.modulation.bias"]}
        if kind == "rgb":
            p[f"b{j}"] = sd[f"{name}.bias"].reshape(-1)
        else:
            p[f"b{j}"] = sd[f"{name}.activate.bias"].reshape(-1)
            p[f"ns{noise_idx}"] = sd[f"{name}.noise.weight"].reshape(())
            noise_idx += 1
    noise = {k[len("noises."):]: np.ascontiguousarray(np.transpose(v, (0, 2, 3, 1)))
             for k, v in sd.items() if k.startswith("noises.")}
    return {"params": p, "noise": noise} if noise else {"params": p}


def _bn_to_jax(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"],
            "mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}


def _stack(trees: list) -> dict:
    """Stack identical trees along a new leading axis (the JAX package's
    scanned units and vmapped heads)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees, axis=0)


def encoder_state_to_jax(state: dict, unit_counts, coarse_ind: int = 3,
                         middle_ind: int = 7) -> dict:
    """e4e ``encoder.`` state dict (prefix stripped) -> JAX
    ``Encoder4Editing`` variables: units 1.. of each stage stacked under
    ``stage{s}_rest``, the heads stacked in coarse / middle / fine groups."""
    sd = {k: _np(v) for k, v in state.items()}
    p: dict = {"input_conv": {"kernel": _hwio(sd["input_layer.0.weight"])},
               "input_bn": _bn_to_jax(sd, "input_layer.1"),
               "input_prelu": {"alpha": sd["input_layer.2.weight"]}}
    for name in ("latlayer1", "latlayer2", "c3_proj"):
        if f"{name}.weight" in sd:
            p[name] = {"kernel": _hwio(sd[f"{name}.weight"]), "bias": sd[f"{name}.bias"]}

    def unit(src):
        u = {"bn1": _bn_to_jax(sd, f"{src}.res_layer.0"),
             "conv1": {"kernel": _hwio(sd[f"{src}.res_layer.1.weight"])},
             "prelu": {"alpha": sd[f"{src}.res_layer.2.weight"]},
             "conv2": {"kernel": _hwio(sd[f"{src}.res_layer.3.weight"])},
             "bn2": _bn_to_jax(sd, f"{src}.res_layer.4"),
             "se": {fc: {"kernel": _in_out(sd[f"{src}.res_layer.5.{fc}.weight"][:, :, 0, 0])}
                    for fc in ("fc1", "fc2")}}
        if f"{src}.shortcut_layer.0.weight" in sd:
            u["shortcut_conv"] = {"kernel": _hwio(sd[f"{src}.shortcut_layer.0.weight"])}
            u["shortcut_bn"] = _bn_to_jax(sd, f"{src}.shortcut_layer.1")
        return u

    i = 0
    for s, n_units in enumerate(unit_counts):
        p[f"stage{s}_unit0"] = unit(f"body.{i}")
        if n_units > 1:
            p[f"stage{s}_rest"] = {"block": _stack([unit(f"body.{i + u}")
                                                    for u in range(1, n_units)])}
        i += n_units

    def head(h):
        out, k = {}, 0
        while f"styles.{h}.convs.{2 * k}.weight" in sd:
            out[f"conv{k}"] = {"kernel": _hwio(sd[f"styles.{h}.convs.{2 * k}.weight"]),
                               "bias": sd[f"styles.{h}.convs.{2 * k}.bias"]}
            k += 1
        out["linear"] = {"kernel": _in_out(sd[f"styles.{h}.linear.weight"]),
                         "bias": sd[f"styles.{h}.linear.bias"]}
        return out

    n = sum(1 for k in sd if k.startswith("styles.") and k.endswith(".linear.weight"))
    bounds = (0, min(coarse_ind, n), min(middle_ind, n), n)
    for name, lo, hi in zip(("heads_coarse", "heads_middle", "heads_fine"), bounds, bounds[1:]):
        if hi > lo:
            p[name] = _stack([head(h) for h in range(lo, hi)])
    return {"params": p}


def vgg_state_to_jax(state: dict) -> dict:
    """``conv*_*.{weight (OIHW), bias}`` -> JAX ``VGG16`` variables."""
    names = sorted({k.rsplit(".", 1)[0] for k in state})
    return {"params": {n: {"kernel": _hwio(state[f"{n}.weight"]), "bias": _np(state[f"{n}.bias"])}
                       for n in names}}


def blender_state_to_jax(state: dict) -> dict:
    """The port blender's state dict (``nets.{node}.gate{i}_fc{1,2}.*``) ->
    JAX ``HierarchyBlender`` params ``{node: {"params": ...}}``."""
    nodes: dict = {}
    for key, v in state.items():
        _, node, rest = key.split(".", 2)
        nodes.setdefault(node, {})[rest] = v
    return {node: fusion_net_state_to_jax(sd) for node, sd in nodes.items()}


def resnet_state_from_jax(variables_np: dict) -> dict:
    """JAX ``ResNet`` variables -> torchvision resnet state dict."""
    p = variables_np["params"]
    sd = {"conv1.weight": _conv(p["conv1"]["kernel"]),
          "fc.weight": _linear(p["fc"]["kernel"]), "fc.bias": np.asarray(p["fc"]["bias"])}
    _bn(sd, "bn1", p["bn1"])
    for name, blk in p.items():
        if not name.startswith("layer"):
            continue
        dst = name.replace("_", ".")  # layer{s}_{b} -> layer{s}.{b}
        sd[f"{dst}.conv1.weight"] = _conv(blk["conv1"]["kernel"])
        _bn(sd, f"{dst}.bn1", blk["bn1"])
        sd[f"{dst}.conv2.weight"] = _conv(blk["conv2"]["kernel"])
        _bn(sd, f"{dst}.bn2", blk["bn2"])
        if "down_conv" in blk:
            sd[f"{dst}.downsample.0.weight"] = _conv(blk["down_conv"]["kernel"])
            _bn(sd, f"{dst}.downsample.1", blk["down_bn"])
    return sd


def vit_state_from_jax(variables_np: dict) -> dict:
    """JAX ``ViTClassifier`` variables -> HF ``ViTForImageClassification``
    state dict."""
    p = variables_np["params"]

    def dense(dst, src):
        sd[f"{dst}.weight"] = _linear(src["kernel"])
        sd[f"{dst}.bias"] = np.asarray(src["bias"])

    def ln(dst, src):
        sd[f"{dst}.weight"] = np.asarray(src["scale"])
        sd[f"{dst}.bias"] = np.asarray(src["bias"])

    emb = "vit.embeddings"
    sd = {f"{emb}.cls_token": np.asarray(p["cls_token"]),
          f"{emb}.position_embeddings": np.asarray(p["pos_emb"]),
          f"{emb}.patch_embeddings.projection.weight": _conv(p["patch_proj"]["kernel"]),
          f"{emb}.patch_embeddings.projection.bias": np.asarray(p["patch_proj"]["bias"])}
    ln("vit.layernorm", p["ln_final"])
    dense("classifier", p["head"])
    i = 0
    while f"block{i}" in p:
        b, L = p[f"block{i}"], f"vit.encoder.layer.{i}"
        ln(f"{L}.layernorm_before", b["ln_before"])
        for name in ("query", "key", "value"):
            dense(f"{L}.attention.attention.{name}", b[name])
        dense(f"{L}.attention.output.dense", b["attn_out"])
        ln(f"{L}.layernorm_after", b["ln_after"])
        dense(f"{L}.intermediate.dense", b["mlp_in"])
        dense(f"{L}.output.dense", b["mlp_out"])
        i += 1
    return sd


def discriminator_state_from_jax(variables_np: dict) -> dict:
    """JAX ``Discriminator`` variables -> the port's (ada-named) state dict.
    JAX flattens the final features in NHWC order before ``final_fc``, the
    port (as ada) in NCHW order, so ``b4.fc``'s input columns are permuted."""
    p = variables_np["params"]
    sizes = [int(k.split("_")[1]) for k in p if k.startswith("block_")]
    size = max(sizes)

    def conv(dst, src, bias=True):
        sd[f"{dst}.weight"] = _conv(src["weight"])
        if bias:
            sd[f"{dst}.bias"] = np.asarray(src["bias"])

    sd: dict = {}
    conv(f"b{size}.fromrgb", p["from_rgb"])
    for res in sizes:
        blk = p[f"block_{res}"]
        conv(f"b{res}.conv0", blk["conv1"])
        conv(f"b{res}.conv1", blk["conv2"])
        conv(f"b{res}.skip", blk["skip"], bias=False)
    conv("b4.conv", p["final_conv"])
    fc = _linear(p["final_fc"]["kernel"])  # (out, 4*4*C), NHWC order
    out_f = fc.shape[0]
    sd["b4.fc.weight"] = np.ascontiguousarray(
        fc.reshape(out_f, 4, 4, -1).transpose(0, 3, 1, 2).reshape(out_f, -1))
    sd["b4.fc.bias"] = np.asarray(p["final_fc"]["bias"])
    sd["b4.out.weight"] = _linear(p["out"]["kernel"])
    sd["b4.out.bias"] = np.asarray(p["out"]["bias"])
    return sd


LANDMARK_LAYERS = ("conv0", "conv1", "conv2", "conv3", "fc1", "head")


def landmark_state_from_jax(variables_np: dict) -> dict:
    """JAX ``LandmarkNet`` variables -> the port's ``LandmarkNet`` state dict:
    ``conv{0..3}`` kernels HWIO -> ``.weight`` OIHW, the ``fc1`` and
    ``head`` Dense kernels (in, out) -> ``.weight`` (out, in), biases as
    they are."""
    p = variables_np["params"]
    sd = {}
    for name in LANDMARK_LAYERS:
        k = np.asarray(p[name]["kernel"])
        sd[f"{name}.weight"] = _conv(k) if k.ndim == 4 else _linear(k)
        sd[f"{name}.bias"] = np.asarray(p[name]["bias"])
    return sd


def landmark_state_to_jax(state: dict) -> dict:
    """The port's ``LandmarkNet`` state dict -> JAX ``LandmarkNet`` variables
    (the inverse of ``landmark_state_from_jax``), for ``save_landmark_net``."""
    params = {}
    for name in LANDMARK_LAYERS:
        w = state[f"{name}.weight"]
        params[name] = {"kernel": _hwio(w) if w.ndim == 4 else _in_out(w),
                        "bias": _np(state[f"{name}.bias"])}
    return {"params": params}


def state_dict_to_torch(sd: dict, device=None) -> dict:
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in sd.items()}

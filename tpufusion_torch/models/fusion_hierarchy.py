"""StyleFusion semantic-part hierarchy and its fusion nets (port of
``tpufusion/models/fusion_hierarchy.py``).

A tree of semantic part nodes per dataset; each internal node owns a small
fusion net that blends its two children's per-layer style codes, gated by
the style code registered under the node's own name:

    g   = sigmoid(fc2(leaky_relu(fc1([s_left ; s_right ; s_base]), 0.2)))
    out = g * s_left + (1 - g) * s_right                  (per channel)

computed in float32 and cast back to ``s_left``'s dtype.
``HierarchyBlender.forward(s_dict)`` walks the tree and returns one blended
style vector. Tree shapes:

  FFHQ:   all(face(eyes, skin_mouth(mouth, skin)),
              bg_hair_clothes(hair, bg(background, shirt)))
  Car:    all(car(car_body, wheels),
              background(background_top, background_bottom))
  Church: all(body, background(background_top, background_bottom))

Fusion-net weights load from a JSON manifest ``{node: weight file}``: ``.npz``
in the JAX package's own save format (``save_fusion_nets`` writes it), or the
reference's torch ``.pt`` / ``.pth`` checkpoints, ingested as an opaque
chained MLP per node (``ChainedMLP``) or, where the stack is not one chain,
the even blend (``EvenBlend``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpufusion_torch.core.dtypes import resolve_device
from tpufusion_torch.core.prng import truncated_normal


@dataclasses.dataclass(frozen=True)
class PartNode:
    name: str
    children: Tuple[str, str] | None = None  # (left, right) or leaf


def _tree(spec: Dict[str, Tuple[str, str]], leaves: Sequence[str]) -> Dict[str, PartNode]:
    nodes = {name: PartNode(name, kids) for name, kids in spec.items()}
    for leaf in leaves:
        nodes[leaf] = PartNode(leaf)
    return nodes


FFHQ_TREE = _tree(
    {
        "all": ("face", "bg_hair_clothes"),
        "face": ("eyes", "skin_mouth"),
        "skin_mouth": ("mouth", "skin"),
        "bg_hair_clothes": ("hair", "bg"),
        "bg": ("background", "shirt"),
    },
    ["eyes", "mouth", "skin", "hair", "background", "shirt"],
)

CAR_TREE = _tree(
    {
        "all": ("car", "background"),
        "car": ("car_body", "wheels"),
        "background": ("background_top", "background_bottom"),
    },
    ["car_body", "wheels", "background_top", "background_bottom"],
)

CHURCH_TREE = _tree(
    {
        "all": ("body", "background"),
        "background": ("background_top", "background_bottom"),
    },
    ["body", "background_top", "background_bottom"],
)

TREES = {"ffhq": FFHQ_TREE, "car": CAR_TREE, "church": CHURCH_TREE}

# Reference part-name aliases (car "body" refers to the car_body node).
ALIASES = {"car": {"body": "car_body"}, "ffhq": {}, "church": {}}


def get_all_active_parts(tree: Dict[str, PartNode], root: str = "all"):
    """All node names of the subtree (internal and leaves), preorder: the
    parts the drawer seeds with the base latent."""
    out = []

    def walk(name):
        out.append(name)
        node = tree[name]
        if node.children:
            for c in node.children:
                walk(c)

    walk(root)
    return out


# ---------------------------------------------------------------------------
# Node forms
# ---------------------------------------------------------------------------

# flax's lecun_normal: a normal truncated to +-2 std, its std corrected so
# that the truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(fan_out, fan_in, device, generator):
    """An (out, in) weight drawn as flax's default ``Dense`` kernel is:
    LeCun normal, truncated at two standard deviations."""
    return truncated_normal((fan_out, fan_in), math.sqrt(1.0 / fan_in) / _TRUNC_STD,
                            device, generator)


class Dense(nn.Module):
    """A float32 linear layer, (out, in) weight, zero-initialised bias."""

    def __init__(self, fan_in, fan_out, *, device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_lecun_normal(fan_out, fan_in, device, generator))
        self.bias = nn.Parameter(torch.zeros(fan_out, device=device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def _gate_blend(g, af, bf, like):
    return (g * af + (1.0 - g) * bf).to(like.dtype)


class FusionNet(nn.Module):
    """Per-layer gated blender of one internal node: one ``gate{i}_fc1``
    (3·dim -> hidden) and ``gate{i}_fc2`` (hidden -> dim) per style layer."""

    def __init__(self, style_dims: Sequence[int], hidden: int = 128, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.style_dims = tuple(int(d) for d in style_dims)
        for i, dim in enumerate(self.style_dims):
            self.add_module(f"gate{i}_fc1", Dense(3 * dim, hidden, device=device,
                                                  generator=generator))
            self.add_module(f"gate{i}_fc2", Dense(hidden, dim, device=device,
                                                  generator=generator))

    def forward(self, left, right, base):
        out = []
        for i, (a, b, c) in enumerate(zip(left, right, base)):
            af, bf = a.float(), b.float()
            h = getattr(self, f"gate{i}_fc1")(torch.cat([af, bf, c.float()], dim=-1))
            g = torch.sigmoid(getattr(self, f"gate{i}_fc2")(F.leaky_relu(h, 0.2)))
            out.append(_gate_blend(g, af, bf, a))
        return tuple(out)


class EvenBlend(nn.Module):
    """The fallback node: the mean of the two children."""

    def forward(self, left, right, base):
        return tuple((0.5 * (a.float() + b.float())).to(a.dtype) for a, b in zip(left, right))


class ChainedMLP(nn.Module):
    """An ingested reference torch fusion net: an ordered stack of linear
    layers (leaky-ReLU 0.2 between them, sigmoid gate at the end), applied
    per style layer wherever its input width is 3·dim ([left; right; base]),
    2·dim ([left; right]) or dim (base) and its output width is dim; the
    other layers take the even blend."""

    def __init__(self, layers, style_dims: Sequence[int]):
        super().__init__()
        self.style_dims = tuple(int(d) for d in style_dims)
        self.weights = nn.ParameterList([nn.Parameter(w) for w, _ in layers])
        self.biases = nn.ParameterList([nn.Parameter(b) for _, b in layers])

    def forward(self, left, right, base):
        fin, fout = self.weights[0].shape[1], self.weights[-1].shape[0]
        out = []
        for d, a, b, c in zip(self.style_dims, left, right, base):
            af, bf, cf = a.float(), b.float(), c.float()
            if fout != d or fin not in (d, 2 * d, 3 * d):
                out.append((0.5 * (af + bf)).to(a.dtype))
                continue
            if fin == 3 * d:
                x = torch.cat([af, bf, cf], dim=-1)
            elif fin == 2 * d:
                x = torch.cat([af, bf], dim=-1)
            else:
                x = cf
            for j, (w, bias) in enumerate(zip(self.weights, self.biases)):
                x = F.linear(x, w, bias)
                if j < len(self.weights) - 1:
                    x = F.leaky_relu(x, 0.2)
            out.append(_gate_blend(torch.sigmoid(x), af, bf, a))
        return tuple(out)


# ---------------------------------------------------------------------------
# The JAX package's .npz format: {"params/gate{i}_fc{1,2}/{kernel,bias}"},
# kernels (in, out)
# ---------------------------------------------------------------------------

def fusion_net_state_from_jax(node_params: dict) -> dict:
    """One node's JAX ``FusionNet`` params ``{"params": {"gate{i}_fc{1,2}":
    {kernel (in, out), bias}}}`` -> its ``FusionNet`` state dict."""
    return {f"{layer}.{name}": np.ascontiguousarray(np.asarray(p[key]).T if key == "kernel"
                                                     else np.asarray(p[key]))
            for layer, p in node_params["params"].items()
            for key, name in (("kernel", "weight"), ("bias", "bias"))}


def fusion_net_state_to_jax(state: dict) -> dict:
    """The inverse of ``fusion_net_state_from_jax``: a ``FusionNet`` state
    dict ``{"gate{i}_fc{1,2}.{weight, bias}"}`` -> ``{"params": {layer:
    {kernel (in, out), bias}}}`` of numpy arrays."""
    params: dict = {}
    for key, t in state.items():
        layer, kind = key.split(".")
        t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        params.setdefault(layer, {})["kernel" if kind == "weight" else "bias"] = (
            np.ascontiguousarray(t.T) if kind == "weight" else t)
    return {"params": params}


class HierarchyBlender(nn.Module):
    """The per-node fusion nets of one dataset's tree and the recursive blend
    (the reference's ``base_blender``), on ``device`` (``cuda`` unless
    given), weights drawn from ``generator``."""

    def __init__(self, dataset: str, style_dims: Sequence[int], *, hidden: int = 128,
                 device=None, generator: Optional[torch.Generator] = None):
        if dataset not in TREES:
            raise ValueError(f"unknown dataset {dataset!r}; one of {sorted(TREES)}")
        super().__init__()
        self.device = resolve_device(device)
        self.dataset = dataset
        self.tree = TREES[dataset]
        self.style_dims = tuple(int(d) for d in style_dims)
        self.internal_nodes = [n for n, node in self.tree.items() if node.children]
        self.nets = nn.ModuleDict({
            name: FusionNet(self.style_dims, hidden, device=self.device, generator=generator)
            for name in self.internal_nodes})
        # set by load_fusion_nets: provenance and match quality of the loaded
        # weights (None until a manifest is loaded)
        self.load_report: Optional[dict] = None

    def forward(self, s_dict: dict, root: str = "all"):
        """Blend the per-part dict (part name -> tuple of (N, C_l) style
        vectors; every node of the tree present) into one style tuple."""

        def walk(name):
            node = self.tree[name]
            if not node.children:
                return s_dict[name]
            return self.nets[name](walk(node.children[0]), walk(node.children[1]),
                                   s_dict[name])

        return walk(root)

    # -- weights -----------------------------------------------------------
    def load_fusion_nets(self, manifest_path: str) -> dict:
        """Load the JSON manifest ``{node: weight path}`` (relative paths
        resolve against the manifest's directory) into the node nets and
        return ``load_report``. ``.npz`` is the JAX package's own format
        (exact); ``.pt`` / ``.pth`` are the reference's torch fusion nets,
        ingested as opaque chained MLPs (``_ingest_torch_fusion_net``); the
        report records each node's match quality."""
        from tpufusion_torch.io.params_io import load_pytree  # io imports this module

        with open(manifest_path) as f:
            manifest = json.load(f)
        root = os.path.dirname(os.path.abspath(manifest_path))
        report = dict(path=manifest_path, nodes={}, approx=False)
        for name, rel in manifest.items():
            path = rel if os.path.isabs(rel) else os.path.join(root, rel)
            if path.endswith((".pt", ".pth")):
                self.nets[name], node_rep = self._ingest_torch_fusion_net(path)
                report["nodes"][name] = node_rep
                # only nodes that fall back to the even blend on some style
                # layer remain approximations
                if not node_rep.get("validated"):
                    report["approx"] = True
            else:
                self.nets[name] = self._net_from_npz(load_pytree(path))
                report["nodes"][name] = dict(format="npz", exact=True)
        torch_nodes = {n: r for n, r in report["nodes"].items() if r.get("format") == "torch"}
        bad = {n: r.get("layers_served") for n, r in torch_nodes.items()
               if not r.get("validated")}
        if bad:
            print("[fusion_hierarchy] WARNING: torch fusion-net checkpoints "
                  "ingested as opaque MLPs — the reference's SFHierarchy "
                  "architecture is not vendored, so gating conventions are "
                  "inferred from tensor shapes (approximation). Nodes with "
                  f"unserved style layers (even-blend fallback): {bad}")
        elif torch_nodes:
            print("[fusion_hierarchy] torch fusion-net checkpoints ingested "
                  "as chained MLPs serving every style layer; the MLP "
                  "forward is torch-oracle-validated (tests/test_fusion.py), "
                  "gating convention inferred from widths")
        self.load_report = report
        return report

    def jax_params(self) -> dict:
        """Every node net as the JAX package's blend params ``{node:
        {"params": ...}}`` (numpy; ``{"__even_blend__": True}`` for an even
        blend). An ingested torch net has no such form and raises."""
        out = {}
        for name, net in self.nets.items():
            if isinstance(net, EvenBlend):
                out[name] = {"__even_blend__": np.asarray(True)}
            elif isinstance(net, FusionNet):
                out[name] = fusion_net_state_to_jax(net.state_dict())
            else:
                raise ValueError(f"node {name!r} holds an ingested torch net; "
                                 "keep its .pt checkpoint in the manifest")
        return out

    def load_jax_params(self, blend_params: dict) -> None:
        """Set the node nets from the JAX package's blend params (the
        ``jax_params`` form, arrays or numpy)."""
        for name, params in blend_params.items():
            self.nets[name] = self._net_from_npz(params)

    def _net_from_npz(self, params: dict) -> nn.Module:
        if "__even_blend__" in params:
            return EvenBlend()
        state = {k: torch.from_numpy(v).to(self.device, torch.float32)
                 for k, v in fusion_net_state_from_jax(params).items()}
        net = FusionNet(self.style_dims, state["gate0_fc1.weight"].shape[0], device="meta")
        net.load_state_dict(state, assign=True)
        return net

    def _ingest_torch_fusion_net(self, path: str):
        """The ordered linear stack (2-D ``*.weight`` with its ``*.bias``;
        torch state dicts keep module order) of a reference fusion-net state
        dict as one ``ChainedMLP``; a stack whose widths do not chain falls
        back to the even blend. Returns (node net, report entry)."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        for wrapper in ("state_dict", "model", "net"):  # common checkpoint wrappers
            if wrapper in state and isinstance(state[wrapper], dict):
                state = state[wrapper]
                break
        layers = []
        for k, w in state.items():
            if not k.endswith(".weight") or not isinstance(w, torch.Tensor) or w.ndim != 2:
                continue
            bkey = k[: -len(".weight")] + ".bias"
            b = state[bkey] if bkey in state else torch.zeros(w.shape[0], dtype=w.dtype)
            layers.append((w.to(self.device, torch.float32),
                           b.to(self.device, torch.float32)))
        if not layers:
            raise ValueError(
                f"{path}: no linear layers found in the torch state dict "
                f"(keys: {sorted(state)[:8]}...) — cannot ingest as a fusion net")
        for j in range(len(layers) - 1):
            w_out, w_in = int(layers[j][0].shape[0]), int(layers[j + 1][0].shape[1])
            if w_out != w_in:
                rep = dict(
                    format="torch", n_linear=len(layers), chained=False,
                    mismatch=f"layer {j} out={w_out} vs layer {j + 1} in={w_in}",
                    layers_served="0 (even-blend fallback: the 2-D weights "
                                  "in this checkpoint do not form one "
                                  "chained MLP)")
                print(f"[fusion_hierarchy] WARNING: {path}: {rep['mismatch']}"
                      " — not a single chained MLP; using even blend for this node")
                return EvenBlend(), rep
        fin, fout = int(layers[0][0].shape[1]), int(layers[-1][0].shape[0])
        served = [d for d in set(self.style_dims) if fin in (d, 2 * d, 3 * d) and fout == d]
        n_served = sum(1 for d in self.style_dims if d in served)
        rep = dict(format="torch", n_linear=len(layers), in_features=fin, out_features=fout,
                   # the chained stack serves every style layer: the state
                   # dict runs as saved; only the gating convention is inferred
                   validated=n_served == len(self.style_dims),
                   layers_served=f"{n_served}/{len(self.style_dims)}")
        return ChainedMLP(layers, self.style_dims), rep

    def save_fusion_nets(self, out_dir: str, manifest_name: str) -> str:
        """Write each node as ``fusion_net_{node}.npz`` in the JAX package's
        format and the manifest naming them; returns the manifest's path.
        An ingested torch net has no such format: save its ``.pt`` instead."""
        from tpufusion_torch.io.params_io import save_pytree  # io imports this module

        os.makedirs(out_dir, exist_ok=True)
        manifest = {}
        for name, params in self.jax_params().items():
            path = save_pytree(params, os.path.join(out_dir, f"fusion_net_{name}.npz"))
            manifest[name] = os.path.basename(path)
        mpath = os.path.join(out_dir, manifest_name)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=2)
        return mpath

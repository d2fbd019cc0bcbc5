"""Plain PyTorch reference of StyleFusion's fusion nets (Kafri et al. 2021,
"StyleFusion: A Generative Model for Disentangling Spatial Segments",
arXiv:2107.06996): the semantic hierarchy of each dataset and the gated
blend of style vectors at each of its internal nodes.

Each internal node blends its two children's style vectors in every style
layer ``i``, gated by the style vectors registered under the node's own name
(its base):

    g   = sigmoid(fc2(leaky_relu(fc1([s_left ; s_right ; s_base]), 0.2)))
    out = g * s_left + (1 - g) * s_right                  (per channel)

and the blend of the whole tree is that of its root, computed from the
leaves up. One ``fc1`` (3 dim -> hidden) and one ``fc2`` (hidden -> dim) a
style layer and node, in float32, under the parameter names of the
program's ``HierarchyBlender`` (``nets.<node>.gate<i>_fc<1|2>.{weight,
bias}``, weights (out, in)), so that one state dict loads into both.
Written from the paper's description; nothing here imports the program.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.numerics import FLOAT32, Numerics

# internal node -> (left child, right child); every other name is a leaf
TREES = {
    "ffhq": {"all": ("face", "bg_hair_clothes"), "face": ("eyes", "skin_mouth"),
             "skin_mouth": ("mouth", "skin"), "bg_hair_clothes": ("hair", "bg"),
             "bg": ("background", "shirt")},
    "car": {"all": ("car", "background"), "car": ("car_body", "wheels"),
            "background": ("background_top", "background_bottom")},
    "church": {"all": ("body", "background"),
               "background": ("background_top", "background_bottom")},
}


class Linear(nn.Module):
    """``nn.Linear``'s parameters, computed through ``nx``."""

    def __init__(self, fan_in, fan_out, nx: Numerics):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.empty(fan_out))
        self.nx = nx

    def forward(self, x):
        return self.nx.linear(x, self.weight, self.bias)


class FusionNet(nn.Module):
    """The gates of one internal node, one pair of layers a style layer."""

    def __init__(self, style_dims, hidden, nx: Numerics):
        super().__init__()
        for i, dim in enumerate(style_dims):
            self.add_module(f"gate{i}_fc1", Linear(3 * dim, hidden, nx))
            self.add_module(f"gate{i}_fc2", Linear(hidden, dim, nx))

    def forward(self, left, right, base):
        out = []
        for i, (a, b, c) in enumerate(zip(left, right, base)):
            h = getattr(self, f"gate{i}_fc1")(torch.cat([a, b, c], dim=-1))
            g = torch.sigmoid(getattr(self, f"gate{i}_fc2")(F.leaky_relu(h, 0.2)))
            out.append(g * a + (1.0 - g) * b)
        return tuple(out)


class HierarchyBlender(nn.Module):
    """The fusion nets of ``dataset``'s tree; ``forward(s_dict)`` blends the
    style vectors of every node (name -> tuple of (N, dim) a style layer)
    into those of ``root``."""

    def __init__(self, dataset, style_dims, hidden=128, nx: Numerics = FLOAT32):
        super().__init__()
        if dataset not in TREES:
            raise ValueError(f"unknown dataset {dataset!r}; one of {sorted(TREES)}")
        self.tree = TREES[dataset]
        self.nets = nn.ModuleDict({name: FusionNet(style_dims, hidden, nx)
                                   for name in self.tree})

    def forward(self, s_dict, root="all"):
        if root not in self.tree:
            return tuple(s.float() for s in s_dict[root])
        left, right = self.tree[root]
        return self.nets[root](self.forward(s_dict, left), self.forward(s_dict, right),
                               tuple(s.float() for s in s_dict[root]))

"""LPIPS perceptual distance: learned linear tap weights on a VGG16 backbone
(port of ``tpufusion/models/lpips.py``).

The reference's legacy white-box variants ``optimize`` / ``optimize_copy``
score reconstructions with ``lpips.LPIPS(net='vgg')``
(`attack_main2.py:687,735`), the public architecture of Zhang et al. 2018:

  1. inputs in [-1, 1] are shifted and scaled by the official
     ``ScalingLayer`` constants;
  2. a standard VGG16 feature stack is tapped after relu1_2, relu2_2,
     relu3_3, relu4_3 and relu5_3;
  3. each tap is unit-normalised over channels (eps 1e-10) in float32;
  4. squared differences pass through a learned 1x1, 1-output conv (the
     "lin" heads ``lin0..lin4``) and are averaged over the plane;
  5. the five scalars are summed.

The backbone is its own: the port's ``VGG16`` (the attacks' perceptual
taps) stops at conv4_2 with a ceil-mode pool3, this one runs through
conv5_3 with floor-mode pools. x0 and x1 go through it as one doubled
batch. Under the CUDA policy the convs compute in bf16 and the
normalisation and heads in float32. The convs stay ``F.conv2d``: the JAX
package leaves them to XLA, not to a Pallas kernel.

Parameters: ``conv1_1.weight`` (OIHW) / ``.bias`` ... ``conv5_3``, and the
heads ``lin0`` ... ``lin4`` in the official (1, C, 1, 1) shape. The official
checkpoints load through ``convert_torch_lpips`` / ``load_torch_lpips``,
the JAX package's variables through ``io.convert.lpips_state_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.models.e4e import Conv2d
from tpufusion_torch.models.vgg16 import _max_pool

# official ScalingLayer constants (applied to [-1, 1] inputs)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

# standard VGG16 conv plan: (name, in, out); a 2x2 max pool precedes each
# block after the first
VGG_PLAN = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
)
POOL_BEFORE = ("conv2_1", "conv3_1", "conv4_1", "conv5_1")
TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")
TAP_CHANNELS = (64, 128, 256, 512, 512)
# torchvision ``vgg16().features`` index of each conv, and the official
# LPIPS slice that holds it (``net.slice{s}.{index}``)
FEATURE_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


class LPIPS(nn.Module):
    """LPIPS('vgg') distance network on ``device`` (``cuda`` unless given),
    weights drawn from ``generator`` (convs LeCun-normal, heads uniform in
    [0, 0.1), as the JAX package's random init) and frozen: it is a metric,
    differentiated with respect to its inputs only.
    ``forward(x0, x1) -> (B,)`` distances of NHWC images in [-1, 1]; one of
    the two batches may be 1 and is then broadcast against the other."""

    def __init__(self, *, policy: Optional[Policy] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.policy = policy or default_policy(device)
        for name, cin, cout in VGG_PLAN:
            self.add_module(name, Conv2d(cin, cout, 3, 1, 1, device=device,
                                         generator=generator))
        for i, ch in enumerate(TAP_CHANNELS):
            lin = torch.rand((1, ch, 1, 1), generator=generator, device=device) * 0.1
            self.register_parameter(f"lin{i}", nn.Parameter(lin))
        self.register_buffer("shift", torch.tensor(SHIFT, device=device), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE, device=device), persistent=False)
        self.requires_grad_(False)

    def taps(self, x):
        """The five relu taps of NHWC ``x``, in the compute dtype."""
        out = ((x.float() - self.shift) / self.scale).to(self.policy.compute_dtype)
        taps = []
        for name, _, _ in VGG_PLAN:
            if name in POOL_BEFORE:
                out = _max_pool(out)
            out = torch.relu(getattr(self, name)(out))
            if name in TAPS:
                taps.append(out)
        return taps

    def forward(self, x0, x1):
        if x0.ndim != 4 or x1.ndim != 4 or x0.shape[1:] != x1.shape[1:] or x0.shape[-1] != 3:
            raise ValueError(f"LPIPS takes two NHWC RGB batches of one image size, got "
                             f"{tuple(x0.shape)} and {tuple(x1.shape)}")
        b0, b1 = x0.shape[0], x1.shape[0]
        if b0 != b1 and 1 not in (b0, b1):
            raise ValueError(f"LPIPS batches of {b0} and {b1} images do not broadcast")
        taps = self.taps(torch.cat([x0, x1.to(x0.dtype)]))
        total = torch.zeros(max(b0, b1), dtype=torch.float32, device=x0.device)
        for i, t in enumerate(taps):
            d = (_unit_normalize(t[:b0]) - _unit_normalize(t[b0:])) ** 2
            lin = getattr(self, f"lin{i}").float().reshape(-1, 1)
            # the learned 1x1 conv is a matmul over the channel axis
            total = total + (d @ lin).squeeze(-1).mean(dim=(1, 2))
        return total


def _unit_normalize(x, eps=1e-10):
    x = x.float()
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + eps)


def convert_torch_lpips(state: dict, backbone: Optional[dict] = None) -> dict:
    """Official torch LPIPS layouts -> this module's state dict.

    ``state`` may be:
      - a full ``lpips.LPIPS`` state dict: backbone convs under
        ``net.slice{1..5}.{index}.weight`` / ``.bias`` and heads under
        ``lin{k}.model.{-1}.weight`` (1, C, 1, 1);
      - the pip package's lin-only checkpoint (``lin*`` keys only), with
        ``backbone`` a torchvision ``vgg16().features`` state dict
        (``{index}.weight`` / ``{index}.bias``).
    Values may be tensors or numpy arrays."""
    names = [n for n, _, _ in VGG_PLAN]
    out = {}
    net_keys = sorted(
        (k for k in state if k.startswith("net.") and k.endswith(".weight")),
        key=lambda k: (int(k.split(".")[1].replace("slice", "")), int(k.split(".")[2])))
    if net_keys:
        if len(net_keys) != len(names):
            raise ValueError(f"expected {len(names)} backbone convs, found "
                             f"{len(net_keys)} ({net_keys[:4]}...)")
        src, keys = state, net_keys
    else:
        if backbone is None:
            raise ValueError("lin-only LPIPS checkpoint needs a torchvision "
                             "vgg16().features state dict as `backbone`")
        keys = sorted((k for k in backbone if k.endswith(".weight")),
                      key=lambda k: int(k.split(".")[0]))
        if len(keys) < len(names):
            raise ValueError(f"backbone has {len(keys)} convs, need {len(names)}")
        src = backbone
    for name, k in zip(names, keys):
        out[f"{name}.weight"] = torch.as_tensor(src[k])
        out[f"{name}.bias"] = torch.as_tensor(src[k[: -len("weight")] + "bias"])
    for i, ch in enumerate(TAP_CHANNELS):
        cand = [k for k in state if k.startswith(f"lin{i}.") and k.endswith(".weight")]
        if not cand:
            raise ValueError(f"no lin{i} head in LPIPS state dict")
        w = torch.as_tensor(state[sorted(cand)[-1]])
        if tuple(w.shape) != (1, ch, 1, 1):
            raise ValueError(f"lin{i}: expected (1, {ch}, 1, 1), got {tuple(w.shape)}")
        out[f"lin{i}"] = w
    return out


def load_torch_lpips(path: str, backbone_path: Optional[str] = None,
                     policy: Optional[Policy] = None, device=None) -> LPIPS:
    """An official LPIPS checkpoint file (and, for a lin-only one, the
    torchvision VGG16 ``features`` file) -> ``LPIPS`` on ``device``."""
    def load(p):
        return torch.load(p, map_location="cpu", weights_only=True)

    state = load(path)
    backbone = load(backbone_path) if backbone_path else None
    model = LPIPS(policy=policy, device=device)
    model.load_state_dict(convert_torch_lpips(state, backbone))
    return model

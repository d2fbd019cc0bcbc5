"""The models' weights, made on the device from the run's seed.

The benchmark makes every weight itself and hands the same state dict to
the program and to the reference. One state dict per model, in the
published checkpoints' layout (rosinality ``g_ema``, e4e ``encoder.``
without the prefix, VGG16 ``conv1_1`` ...). Each model's floating-point
leaves are cut from one normal draw of a ``torch.Generator`` on the device,
then scaled by their kind (``_init``): no checkpoint is read and nothing is
drawn leaf by leaf on the host.

The scales follow each architecture's own initialisation where it has one
(StyleGAN2's equalised learning rate stores unit-normal weights, the mapping
layers' divided by their lr multiplier; the style modulations start at bias
1), and otherwise keep activations of order one (LeCun normal for e4e's
convolutions and the fusion nets' gates, He normal for VGG16's ReLU
stack). Biases, noise strengths, BatchNorm statistics and PReLU slopes get
small random values around their usual starting points, so that every
parameter takes part, as in a trained checkpoint.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import fusion_nets
from portbench.reference import models as ref


def mix(seed: int, stream: int) -> int:
    """A generator seed for one stream of draws of a run's seed."""
    return (int(seed) * 1_000_003 + stream) % (2 ** 63)


def _fir():
    return ref.make_kernel(gain=4.0)


def _init(model: str, name: str, shape, names) -> tuple:
    """``(std, mean)`` of a normal leaf, or a fixed tensor: the leaf's
    kind, from its name within ``model``."""
    last = name.rsplit(".", 1)[-1]
    prefix = name[: -len(last) - 1] if "." in name else ""
    if last == "kernel":
        return _fir()
    if last == "num_batches_tracked":
        return torch.zeros((), dtype=torch.long)
    if last == "running_mean":
        return (0.1, 0.0)
    if last == "running_var":
        return ("lognormal", 0.2)
    is_bn = f"{prefix}.running_mean" in names
    if model == "fusion_nets":
        # LeCun normal, the program's own ``Dense`` initialisation: the gates'
        # pre-activations of order one, in the sigmoid's live range as a
        # trained checkpoint's are (a unit normal would saturate every gate)
        return (0.1, 0.0) if last == "bias" else (math.sqrt(1.0 / shape[1]), 0.0)
    if model == "generator":
        if name.startswith("style.") and last == "weight":
            return (100.0, 0.0)  # EqualLinear stores weight / lr_mul (0.01)
        if prefix.endswith("modulation"):
            return (1.0, 0.0) if last == "weight" else (0.1, 1.0)
        if last == "weight" and prefix.endswith("noise"):
            return (0.1, 0.0)
        if last == "bias":
            return (0.1, 0.0)
        return (1.0, 0.0)  # conv weights, the constant input, the noise planes
    if is_bn:
        return (0.1, 1.0) if last == "weight" else (0.1, 0.0)
    if last == "bias":
        return (0.01, 0.0) if model == "vgg16" else (0.1, 0.0)
    if len(shape) == 1:  # PReLU slopes
        return (0.05, 0.25)
    if len(shape) == 2:  # EqualLinear of the style heads: unit normal
        return (1.0, 0.0)
    fan_in = math.prod(shape[1:])
    gain = 2.0 if model == "vgg16" else 1.0
    return (math.sqrt(gain / fan_in), 0.0)


def reference_modules(config: dict, nx=None, device="meta") -> dict:
    """The reference models of ``config`` with empty leaves on ``device``
    (``meta`` by default: shapes only): the generator, the encoder, VGG16's
    taps and, where the config has a ``fusion_nets`` block, StyleFusion's
    fusion nets of its dataset's tree, in that order."""
    g, e = config["generator"], config["encoder"]
    kw = {} if nx is None else dict(nx=nx)
    with torch.device(device):
        mods = {
            "generator": ref.Generator(g["size"], g["style_dim"], g["n_mlp"],
                                       g["channel_multiplier"], **kw),
            "encoder": ref.Encoder4Editing(e["n_styles"], g["style_dim"], e["base_channels"],
                                           tuple(e["unit_counts"]), e["input_size"],
                                           e["coarse_ind"], e["middle_ind"], **kw),
            "vgg16": ref.VGG16Taps(**kw),
        }
        if "fusion_nets" in config:
            mods["fusion_nets"] = fusion_nets.HierarchyBlender(
                config["dataset"], mods["generator"].style_input_dims(),
                int(config["fusion_nets"]["hidden"]), **kw)
        return mods


def make_state(config: dict, seed: int, device) -> dict:
    """``{model: state dict}`` of ``reference_modules``: every leaf of the
    config's models, from ``seed``, on ``device``. Each model draws from its
    own stream, by its place in that order, so a model added at the end
    leaves the others' leaves as they were."""
    out = {}
    for k, (model, module) in enumerate(reference_modules(config).items()):
        shapes = {n: tuple(t.shape) for n, t in module.state_dict().items()}
        names = set(shapes)
        kinds = {n: _init(model, n, s, names) for n, s in shapes.items()}
        drawn = [n for n, kind in kinds.items() if isinstance(kind, tuple)]
        total = sum(math.prod(shapes[n]) for n in drawn)
        gen = torch.Generator(device=device).manual_seed(mix(seed, k))
        flat = torch.randn(total, generator=gen, device=device)
        sd, at = {}, 0
        for n in shapes:
            kind = kinds[n]
            if not isinstance(kind, tuple):
                sd[n] = kind.to(device)
                continue
            size = math.prod(shapes[n])
            leaf = flat[at: at + size].view(shapes[n])
            at += size
            if kind[0] == "lognormal":
                leaf.mul_(kind[1]).exp_()
            else:
                leaf.mul_(kind[0]).add_(kind[1])
            sd[n] = leaf
        out[model] = sd
    return out


def reference_models(config: dict, state: dict, nx=None) -> dict:
    """The reference models that ``state`` holds weights for, holding its
    tensors (no copy), frozen."""
    mods = {k: m for k, m in reference_modules(config, nx).items() if k in state}
    for name, module in mods.items():
        module.load_state_dict(state[name], assign=True)
        module.requires_grad_(False).eval()
    return mods


@torch.no_grad()
def mean_latent(generator: "ref.Generator", seed: int, samples: int) -> torch.Tensor:
    """(1, style_dim): the mapping network's mean over ``samples`` z drawn
    from ``seed`` (the truncation centre; the attacks measured here do not
    read it, the program's pipeline holds it)."""
    device = generator.input.input.device
    gen = torch.Generator(device=device).manual_seed(mix(seed, 99))
    z = torch.randn(samples, generator.style_dim, generator=gen, device=device)
    return generator.style(z).mean(dim=0, keepdim=True)

"""StyleGAN2 generator with the StyleFusion style-vector API (port of
``tpufusion/models/stylegan2.py``).

Parameters and buffers carry rosinality ``g_ema`` names and shapes
(``style.{1..8}``, ``input.input``, ``conv1.conv.weight`` (1, out, in, k, k),
``conv1.conv.modulation.{weight,bias}``, ``conv1.noise.weight``,
``conv1.activate.bias``, ``to_rgb1``, ``convs.{i}``, ``to_rgbs.{i}``,
``noises.noise_{i}``), so a ``stylegan2-*-config-f.pt`` state dict loads with
``load_state_dict``. Activations are NHWC.

Style-vector ordering (tuple of (N, Cin) tensors):
    [conv1, to_rgb1, (conv_up, conv, to_rgb) per resolution 8..size]
Each modulated conv's ``modulation`` is the affine that makes its entry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.ops.modconv import modulated_conv2d
from tpufusion_torch.ops.styled_conv import UP_TAPS, noise_bias_act, styled_conv, styled_conv_up
from tpufusion_torch.ops.upfirdn2d import make_blur_kernel, upsample_2x

SQRT2 = math.sqrt(2.0)


def channel_map(size: int, channel_multiplier: int = 2, base: int = 512) -> dict:
    """Per-resolution channel widths (rosinality config-f table)."""
    return {
        4: base, 8: base, 16: base, 32: base,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


def whole(t: torch.Tensor) -> torch.Tensor:
    """``t``, or the whole tensor of a DTensor leaf, gathered over the
    ``model`` axis (tensor parallelism, ``parallel.shard_generator_params``):
    the forward uses every weight whole, so the kernels keep their shapes."""
    full = getattr(t, "full_tensor", None)
    return t if full is None else full()


def _randn(shape, generator, device, std=1.0):
    return torch.randn(shape, generator=generator, device=device) * std


class EqualLinear(nn.Module):
    """Linear layer with equalized learning rate (scale = lr_mul/sqrt(fan_in));
    the weight is stored pre-divided by lr_mul, as in rosinality."""

    def __init__(self, in_dim, out_dim, *, lr_mul=1.0, bias_init=0.0, activate=False,
                 policy: Policy, device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((out_dim, in_dim), generator, device) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init), device=device))
        self.scale = lr_mul / math.sqrt(in_dim)
        self.lr_mul = lr_mul
        self.activate = activate
        self.compute_dtype = policy.compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        w = whole(self.weight).to(dt) * self.scale
        y = x.to(dt) @ w.t() + (self.bias * self.lr_mul).to(dt)
        if self.activate:
            y = F.leaky_relu(y, 0.2) * SQRT2
        return y


class PixelNorm(nn.Module):
    def forward(self, x):
        ms = torch.mean(x.float() ** 2, dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + 1e-8).to(x.dtype)


class MappingNetwork(nn.Sequential):
    """z -> w: PixelNorm + n_mlp EqualLinear(lr_mul=0.01) layers
    (rosinality ``style``: ``style.0`` is the PixelNorm)."""

    def __init__(self, style_dim=512, n_mlp=8, *, policy: Policy, device=None,
                 generator=None):
        layers = [PixelNorm()] + [
            EqualLinear(style_dim, style_dim, lr_mul=0.01, activate=True, policy=policy,
                        device=device, generator=generator)
            for _ in range(n_mlp)]
        super().__init__(*layers)
        self.compute_dtype = policy.compute_dtype

    def forward(self, z):
        return super().forward(z.to(self.compute_dtype))


class _FIRKernel(nn.Module):
    """Holds rosinality's ``Blur``/``Upsample`` FIR buffer (``kernel``): the
    checkpoints carry it, so the state dict does too. The synthesis builds
    the same taps from ``blur_taps`` (``ops/upfirdn2d.py``)."""

    def __init__(self, taps, device=None):
        super().__init__()
        self.register_buffer("kernel", make_blur_kernel(taps, gain=4.0, device=device))


class ModulatedConv2d(nn.Module):
    """rosinality ``ModulatedConv2d`` parameters; the math is
    ``ops.modconv.modulated_conv2d`` (input scaling + output demodulation)."""

    def __init__(self, cin, cout, k, style_dim, *, demodulate=True, upsample=False,
                 blur_taps=(1, 3, 3, 1), policy: Policy, device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((1, cout, cin, k, k), generator, device))
        self.modulation = EqualLinear(style_dim, cin, bias_init=1.0, policy=policy,
                                      device=device, generator=generator)
        if upsample:
            self.blur = _FIRKernel(blur_taps, device)
        self.demodulate = demodulate
        self.upsample = upsample
        self.blur_taps = tuple(blur_taps)

    def hwio(self) -> torch.Tensor:
        """(kh, kw, Cin, Cout) view of the (1, out, in, k, k) weight."""
        return whole(self.weight)[0].permute(2, 3, 1, 0)

    def forward(self, x, s):
        return modulated_conv2d(x, self.hwio(), s, demodulate=self.demodulate,
                                up=self.upsample, blur_taps=self.blur_taps)


class NoiseInjection(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, device=device))


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels, device=device))


class StyledConv(nn.Module):
    """rosinality ``StyledConv`` parameters (conv, noise, activate); the
    generator's ``_styled_conv`` routes the math."""

    def __init__(self, cin, cout, style_dim, *, upsample=False, blur_taps=(1, 3, 3, 1),
                 policy: Policy, device=None, generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(cin, cout, 3, style_dim, upsample=upsample,
                                    blur_taps=blur_taps, policy=policy, device=device,
                                    generator=generator)
        self.noise = NoiseInjection(device)
        self.activate = FusedLeakyReLU(cout, device)


class ToRGB(nn.Module):
    def __init__(self, cin, style_dim, *, upsample=True, blur_taps=(1, 3, 3, 1),
                 policy: Policy, device=None, generator=None):
        super().__init__()
        if upsample:
            self.upsample = _FIRKernel(blur_taps, device)
        self.conv = ModulatedConv2d(cin, 3, 1, style_dim, demodulate=False, policy=policy,
                                    device=device, generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1, device=device))


class ConstantInput(nn.Module):
    def __init__(self, channels, *, device=None, generator=None):
        super().__init__()
        self.input = nn.Parameter(_randn((1, channels, 4, 4), generator, device))


@dataclasses.dataclass
class GeneratorOutput:
    image: torch.Tensor            # (N, size, size, 3) float32
    features: tuple                # inner feature maps, one per resolution
    latents: Optional[torch.Tensor] = None  # (N, n_latent, style_dim) W+
    styles: Optional[tuple] = None          # per-layer style vectors s


class Generator(nn.Module):
    """StyleGAN2 synthesis + mapping with style-vector injection/extraction.

    Weights are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``, which is ``cuda`` unless given); a checkpoint replaces them
    with ``load_state_dict``. Noise buffers are loaded, never redrawn
    (``randomize_noise=False``)."""

    def __init__(self, size: int = 1024, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, blur_taps: Sequence[int] = (1, 3, 3, 1), *,
                 policy: Optional[Policy] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        policy = policy or default_policy(device)
        self.size = size
        self.style_dim = style_dim
        self.n_mlp = n_mlp
        self.channel_multiplier = channel_multiplier
        self.blur_taps = tuple(blur_taps)
        self.policy = policy
        kw = dict(policy=policy, device=device, generator=generator)
        ch = channel_map(size, channel_multiplier)

        self.style = MappingNetwork(style_dim, n_mlp, **kw)
        self.input = ConstantInput(ch[4], device=device, generator=generator)
        self.conv1 = StyledConv(ch[4], ch[4], style_dim, blur_taps=blur_taps, **kw)
        self.to_rgb1 = ToRGB(ch[4], style_dim, upsample=False, blur_taps=blur_taps, **kw)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        cin = ch[4]
        for i in range(3, self.log_size + 1):
            cout = ch[2 ** i]
            self.convs.append(StyledConv(cin, cout, style_dim, upsample=True,
                                         blur_taps=blur_taps, **kw))
            self.convs.append(StyledConv(cout, cout, style_dim, blur_taps=blur_taps, **kw))
            self.to_rgbs.append(ToRGB(cout, style_dim, blur_taps=blur_taps, **kw))
            cin = cout
        self.noises = nn.Module()
        for i in range(self.n_noise):
            res = 4 * 2 ** ((i + 1) // 2)
            self.noises.register_buffer(f"noise_{i}", _randn((1, 1, res, res), generator, device))

    # ---- static structure ------------------------------------------------
    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def n_latent(self) -> int:
        """W+ rows: 18 @1024, 16 @512, 14 @256."""
        return self.log_size * 2 - 2

    @property
    def n_styles(self) -> int:
        """Total modulated convs = conv1 + to_rgb1 + 3 per block."""
        return 2 + 3 * (self.log_size - 2)

    @property
    def n_noise(self) -> int:
        return 1 + 2 * (self.log_size - 2)

    @property
    def device(self) -> torch.device:
        return self.input.input.device

    def conv_plan(self):
        """(cin, cout, kind) per modulated conv, in style-vector order."""
        ch = channel_map(self.size, self.channel_multiplier)
        plan = [(ch[4], ch[4], "conv"), (ch[4], 3, "rgb")]
        cin = ch[4]
        res = 8
        while res <= self.size:
            cout = ch[res]
            plan += [(cin, cout, "up"), (cout, cout, "conv"), (cout, 3, "rgb")]
            cin = cout
            res *= 2
        return plan

    def style_input_dims(self):
        """Width of each style vector (the input channels of its conv)."""
        return [cin for cin, _, _ in self.conv_plan()]

    def w_index_plan(self):
        """Which W+ row feeds each modulated conv (rosinality layer wiring)."""
        idx = [0, 1]
        i = 1
        for _ in range(self.log_size - 2):
            idx += [i, i + 1, i + 2]
            i += 2
        return idx

    def modulated_convs(self):
        """The modulated convs in style-vector order."""
        layers = [self.conv1.conv, self.to_rgb1.conv]
        for j, to_rgb in enumerate(self.to_rgbs):
            layers += [self.convs[2 * j].conv, self.convs[2 * j + 1].conv, to_rgb.conv]
        return layers

    # ---- public API ------------------------------------------------------
    def mean_latent(self, n_sample: int, generator: Optional[torch.Generator] = None):
        """Mean mapped w over ``n_sample`` random z, (1, style_dim) float32."""
        z = torch.randn((n_sample, self.style_dim), generator=generator, device=self.device,
                        dtype=self.policy.compute_dtype)
        return self.style(z).float().mean(dim=0, keepdim=True)

    def styles_from_w_plus(self, w_plus: torch.Tensor) -> tuple:
        """(N, n_latent, style_dim) W+ -> per-conv style vectors s."""
        idx = self.w_index_plan()
        return tuple(layer.modulation(w_plus[:, idx[i]])
                     for i, layer in enumerate(self.modulated_convs()))

    def forward(self, styles=None, *, input_is_latent: bool = False,
                truncation: float = 1.0, truncation_latent=None,
                randomize_noise: bool = False,
                noise_generator: Optional[torch.Generator] = None,
                inject_index: Optional[int] = None, return_latents: bool = False,
                return_style_vector: bool = False, style_vector=None):
        """Synthesis. Returns the style-vector tuple
        (``return_style_vector=True``) or a ``GeneratorOutput``."""
        if style_vector is None:
            w_plus = self._to_w_plus(styles, input_is_latent, truncation,
                                     truncation_latent, inject_index)
            s = self.styles_from_w_plus(w_plus)
        else:
            w_plus = None
            s = tuple(style_vector)
        if return_style_vector:
            return s
        image, features = self._synthesis(s, randomize_noise, noise_generator)
        return GeneratorOutput(image=image, features=features,
                               latents=w_plus if return_latents else None, styles=s)

    # ---- internals -------------------------------------------------------
    def _to_w_plus(self, styles, input_is_latent, truncation, truncation_latent,
                   inject_index):
        if not isinstance(styles, (list, tuple)):
            styles = [styles]
        ws = list(styles) if input_is_latent else [self.style(z) for z in styles]
        if truncation != 1.0:
            if truncation_latent is None:
                raise ValueError("truncation < 1 requires truncation_latent")
            tl = truncation_latent.float()
            ws = [(tl + truncation * (w.float() - tl)).to(w.dtype) for w in ws]
        if len(ws) == 1:
            w = ws[0]
            return w[:, None, :].repeat(1, self.n_latent, 1) if w.dim() == 2 else w
        if inject_index is None:
            inject_index = self.n_latent // 2
        w1 = ws[0][:, None, :].repeat(1, inject_index, 1)
        w2 = ws[1][:, None, :].repeat(1, self.n_latent - inject_index, 1)
        return torch.cat([w1, w2], dim=1)

    def _noise_plane(self, i):
        """Noise buffer ``i`` as a shared (1, H, W, 1) NHWC plane."""
        return getattr(self.noises, f"noise_{i}").permute(0, 2, 3, 1)

    def _styled_conv(self, x, layer: StyledConv, noise_idx, s, up, randomize, noise_gen):
        w = layer.conv.hwio()
        ns = layer.noise.weight.reshape(())
        b = layer.activate.bias
        if not randomize:
            # the fused kernels on the card: the styled conv, and the up conv
            # with the blur folded into its weights
            if not up:
                return styled_conv(x, w, s, self._noise_plane(noise_idx), ns, b)
            if self.blur_taps == UP_TAPS:
                return styled_conv_up(x, w, s, self._noise_plane(noise_idx), ns, b)
        y = modulated_conv2d(x, w, s, demodulate=True, up=up, blur_taps=self.blur_taps)
        if randomize:
            if noise_gen is None:
                raise ValueError("randomize_noise=True requires noise_generator")
            noise = torch.randn(y.shape[:3] + (1,), generator=noise_gen, device=y.device)
        else:
            noise = self._noise_plane(noise_idx)
        return noise_bias_act(y, noise, ns, b)

    def _to_rgb(self, x, layer: ToRGB, s, skip=None):
        y = modulated_conv2d(x, layer.conv.hwio(), s, demodulate=False)
        y = y + layer.bias.reshape(-1).to(y.dtype)
        if skip is not None:
            y = y + upsample_2x(skip, self.blur_taps).to(y.dtype)
        return y

    def _synthesis(self, s, randomize_noise, noise_gen):
        n = s[0].shape[0]
        const = self.input.input.permute(0, 2, 3, 1).to(self.policy.compute_dtype)
        x = const.expand(n, -1, -1, -1)
        x = self._styled_conv(x, self.conv1, 0, s[0], False, randomize_noise, noise_gen)
        features = [x]
        skip = self._to_rgb(x, self.to_rgb1, s[1])
        ci, ni = 2, 1
        for j, to_rgb in enumerate(self.to_rgbs):
            x = self._styled_conv(x, self.convs[2 * j], ni, s[ci], True, randomize_noise,
                                  noise_gen)
            x = self._styled_conv(x, self.convs[2 * j + 1], ni + 1, s[ci + 1], False,
                                  randomize_noise, noise_gen)
            features.append(x)
            skip = self._to_rgb(x, to_rgb, s[ci + 2], skip)
            ci += 3
            ni += 2
        return skip.float(), tuple(features)

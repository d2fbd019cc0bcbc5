"""Plain PyTorch reference of the models the attacks differentiate through.

A frozen copy of the published architectures, written from their
descriptions and not from the program under test: rosinality's StyleGAN2
generator (Karras et al. 2020, config-f), the e4e IR-SE-50 encoder
(Tov et al. 2021) and the SSD-style VGG16 tap stack of the paper's
``vgg.py``. The parameter names are the published checkpoints' (rosinality
``g_ema``, e4e ``encoder.`` without the prefix, ``conv1_1`` ...), so one
state dict loads into these modules and into the program's.

Departures from the published code, none of which changes the function:
- the modulated convolution is rosinality's unfused form (the input scaled
  by the style, one convolution shared by the batch, the output
  demodulated) rather than the grouped convolution: the same sums;
- every convolution and linear layer runs through a ``Numerics`` object,
  float32 unless the control asks for float8 (``numerics.py``);
- frozen BatchNorm is ``F.batch_norm`` in inference mode.

Activations are NCHW. Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.numerics import FLOAT32, Numerics

SQRT2 = math.sqrt(2.0)


# ---------------------------------------------------------------------------
# upfirdn2d (rosinality semantics, plain path)
# ---------------------------------------------------------------------------


def upfirdn2d(x, kernel, up=1, pad=(0, 0)):
    """NCHW zero-stuffed upsample, pad, FIR (a true convolution)."""
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros(n, c, h, up, w, up)
        z[:, :, :, 0, :, 0] = x
        x = z.view(n, c, h * up, w * up)
    p0, p1 = pad
    x = F.pad(x, [p0, p1, p0, p1])
    filt = torch.flip(kernel, [0, 1])[None, None].to(x.dtype).repeat(c, 1, 1, 1)
    return F.conv2d(x, filt, groups=c)


def make_kernel(taps=(1, 3, 3, 1), gain=1.0):
    k = torch.tensor(taps, dtype=torch.float32)
    k = k[None, :] * k[:, None]
    return k / k.sum() * gain


class Blur(nn.Module):
    def __init__(self, pad, gain=1.0):
        super().__init__()
        self.register_buffer("kernel", make_kernel(gain=gain))
        self.pad = pad

    def forward(self, x):
        return upfirdn2d(x, self.kernel, pad=self.pad)


class Upsample(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("kernel", make_kernel(gain=4.0))

    def forward(self, x):
        p = self.kernel.shape[0] - 2
        return upfirdn2d(x, self.kernel, up=2, pad=((p + 1) // 2 + 1, p // 2))


# ---------------------------------------------------------------------------
# StyleGAN2 (rosinality layout)
# ---------------------------------------------------------------------------


class PixelNorm(nn.Module):
    def forward(self, x):
        return x * torch.rsqrt(torch.mean(x ** 2, dim=1, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim, nx: Numerics, bias_init=0.0, lr_mul=1.0,
                 activation=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.scale = lr_mul / math.sqrt(in_dim)
        self.lr_mul = lr_mul
        self.activation = activation
        self.nx = nx

    def forward(self, x):
        out = self.nx.linear(x, self.weight * self.scale, self.bias * self.lr_mul)
        return F.leaky_relu(out, 0.2) * SQRT2 if self.activation else out


class ModulatedConv2d(nn.Module):
    def __init__(self, cin, cout, k, style_dim, nx: Numerics, demodulate=True,
                 upsample=False):
        super().__init__()
        self.k, self.cin, self.cout = k, cin, cout
        self.upsample, self.demodulate = upsample, demodulate
        if upsample:
            p = (4 - 2) - (k - 1)
            self.blur = Blur(((p + 1) // 2 + 1, p // 2 + 1), gain=4.0)
        self.scale = 1.0 / math.sqrt(cin * k * k)
        self.weight = nn.Parameter(torch.empty(1, cout, cin, k, k))
        self.modulation = EqualLinear(style_dim, cin, nx, bias_init=1.0)
        self.nx = nx

    def forward(self, x, w_row):
        return self.modulated(x, self.modulation(w_row))

    def modulated(self, x, style):
        """The convolution of ``x`` under the style vector ``style`` (b,
        cin): the layer from its style on."""
        b = x.shape[0]
        weight = self.scale * self.weight[0]  # (cout, cin, k, k)
        x = x * style.view(b, self.cin, 1, 1)
        if self.upsample:
            out = self.blur(self.nx.conv_transpose2d(x, weight.transpose(0, 1), stride=2))
        else:
            out = self.nx.conv2d(x, weight, padding=self.k // 2)
        if self.demodulate:
            w2 = weight.square().sum((2, 3)).t()  # (cin, cout)
            d = torch.rsqrt(style.square() @ w2 + 1e-8)
            out = out * d.view(b, self.cout, 1, 1)
        return out


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.leaky_relu(x + self.bias.view(1, -1, 1, 1), 0.2) * SQRT2


class StyledConv(nn.Module):
    def __init__(self, cin, cout, style_dim, nx, upsample=False):
        super().__init__()
        self.conv = ModulatedConv2d(cin, cout, 3, style_dim, nx, upsample=upsample)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(cout)

    def forward(self, x, w_row, noise):
        return self.styled(x, self.conv.modulation(w_row), noise)

    def styled(self, x, style, noise):
        return self.activate(self.conv.modulated(x, style) + self.noise.weight * noise)


class ToRGB(nn.Module):
    def __init__(self, cin, style_dim, nx, upsample=True):
        super().__init__()
        if upsample:
            self.upsample = Upsample()
        self.conv = ModulatedConv2d(cin, 3, 1, style_dim, nx, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, w_row, skip=None):
        return self.styled(x, self.conv.modulation(w_row), skip)

    def styled(self, x, style, skip=None):
        out = self.conv.modulated(x, style) + self.bias
        return out if skip is None else out + self.upsample(skip)


class ConstantInput(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.input = nn.Parameter(torch.empty(1, channels, 4, 4))


def channel_map(channel_multiplier=2):
    c = channel_multiplier
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * c, 128: 128 * c, 256: 64 * c,
            512: 32 * c, 1024: 16 * c}


class Generator(nn.Module):
    """Synthesis from W+ codes (``input_is_latent``) or from style vectors,
    and the mapping network (``style``), with rosinality's parameter names."""

    def __init__(self, size, style_dim=512, n_mlp=8, channel_multiplier=2,
                 nx: Numerics = FLOAT32):
        super().__init__()
        ch = channel_map(channel_multiplier)
        self.size, self.style_dim = size, style_dim
        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, nx, lr_mul=0.01, activation=True)
            for _ in range(n_mlp)])
        self.input = ConstantInput(ch[4])
        self.conv1 = StyledConv(ch[4], ch[4], style_dim, nx)
        self.to_rgb1 = ToRGB(ch[4], style_dim, nx, upsample=False)
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        self.noises = nn.Module()
        for i in range(self.num_layers):
            res = 4 * 2 ** ((i + 1) // 2)
            self.noises.register_buffer(f"noise_{i}", torch.empty(1, 1, res, res))
        cin = ch[4]
        for i in range(3, self.log_size + 1):
            cout = ch[2 ** i]
            self.convs.append(StyledConv(cin, cout, style_dim, nx, upsample=True))
            self.convs.append(StyledConv(cout, cout, style_dim, nx))
            self.to_rgbs.append(ToRGB(cout, style_dim, nx))
            cin = cout

    def modulated_convs(self):
        """``(conv, W+ row)`` of each modulated convolution, in the order of
        the style vectors (S space): conv1, to_rgb1, then each level's up
        conv, conv and to_rgb."""
        out = [(self.conv1.conv, 0), (self.to_rgb1.conv, 1)]
        for j, to_rgb in enumerate(self.to_rgbs):
            i = 1 + 2 * j
            out += [(self.convs[2 * j].conv, i), (self.convs[2 * j + 1].conv, i + 1),
                    (to_rgb.conv, i + 2)]
        return out

    def style_input_dims(self):
        """The width of each style vector (its convolution's input channels)."""
        return [conv.cin for conv, _ in self.modulated_convs()]

    def styles(self, latent):
        """(N, n_latent, style_dim) W+ codes -> the style vectors, one
        (N, cin) a modulated convolution."""
        return tuple(conv.modulation(latent[:, row]) for conv, row in self.modulated_convs())

    def forward(self, latent):
        """(N, n_latent, style_dim) W+ codes -> (N, 3, size, size) image."""
        return self.synthesis(self.styles(latent))

    def synthesis(self, styles):
        """Style vectors (``styles``' order) -> (N, 3, size, size) image."""
        noise = [getattr(self.noises, f"noise_{i}") for i in range(self.num_layers)]
        out = self.input.input.repeat(styles[0].shape[0], 1, 1, 1)
        out = self.conv1.styled(out, styles[0], noise[0])
        skip = self.to_rgb1.styled(out, styles[1])
        s = 2
        for conv_up, conv, n1, n2, to_rgb in zip(self.convs[::2], self.convs[1::2],
                                                 noise[1::2], noise[2::2], self.to_rgbs):
            out = conv_up.styled(out, styles[s], n1)
            out = conv.styled(out, styles[s + 1], n2)
            skip = to_rgb.styled(out, styles[s + 2], skip)
            s += 3
        return skip


# ---------------------------------------------------------------------------
# e4e IR-SE encoder (checkpoint layout, ``encoder.`` stripped)
# ---------------------------------------------------------------------------


class Conv2d(nn.Module):
    """``nn.Conv2d``'s parameters, computed through ``nx``."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, nx: Numerics = FLOAT32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding, self.nx = stride, padding, nx

    def forward(self, x):
        return self.nx.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class BatchNorm(nn.Module):
    """``nn.BatchNorm2d``'s state in inference mode."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-5)


class SEModule(nn.Module):
    def __init__(self, channels, nx, reduction=16):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.fc1 = Conv2d(channels, mid, 1, bias=False, nx=nx)
        self.fc2 = Conv2d(mid, channels, 1, bias=False, nx=nx)

    def forward(self, x):
        s = F.adaptive_avg_pool2d(x, 1)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIRSE(nn.Module):
    def __init__(self, cin, depth, stride, nx):
        super().__init__()
        self.stride = stride
        if cin == depth:
            self.shortcut_layer = None  # MaxPool2d(1, stride)
        else:
            self.shortcut_layer = nn.Sequential(Conv2d(cin, depth, 1, stride, bias=False, nx=nx),
                                                BatchNorm(depth))
        self.res_layer = nn.Sequential(
            BatchNorm(cin), Conv2d(cin, depth, 3, 1, 1, bias=False, nx=nx), nn.PReLU(depth),
            Conv2d(depth, depth, 3, stride, 1, bias=False, nx=nx), BatchNorm(depth),
            SEModule(depth, nx))

    def forward(self, x):
        if self.shortcut_layer is None:
            short = F.max_pool2d(x, 1, self.stride)
        else:
            short = self.shortcut_layer(x)
        return self.res_layer(x) + short


class GradualStyleBlock(nn.Module):
    def __init__(self, cin, cout, spatial, nx):
        super().__init__()
        mods = []
        for i in range(int(math.log2(spatial))):
            mods += [Conv2d(cin if i == 0 else cout, cout, 3, 2, 1, nx=nx), nn.LeakyReLU()]
        self.convs = nn.Sequential(*mods)
        self.linear = EqualLinear(cout, cout, nx)
        self.cout = cout

    def forward(self, x):
        return self.linear(self.convs(x).reshape(-1, self.cout))


class Encoder4Editing(nn.Module):
    """IR-SE backbone, feature pyramid and progressive style heads: an
    (N, 3, s, s) image to (N, n_styles, style_dim) raw codes."""

    def __init__(self, n_styles=18, style_dim=512, base_channels=64, unit_counts=(3, 4, 14, 3),
                 input_size=256, coarse_ind=3, middle_ind=7, nx: Numerics = FLOAT32):
        super().__init__()
        b = base_channels
        depths = (b, 2 * b, 4 * b, 8 * b)
        self.n_styles, self.coarse_ind, self.middle_ind = n_styles, coarse_ind, middle_ind
        self.input_layer = nn.Sequential(Conv2d(3, b, 3, 1, 1, bias=False, nx=nx),
                                         BatchNorm(b), nn.PReLU(b))
        blocks, taps, cin = [], [], b
        for stage, (depth, n_units) in enumerate(zip(depths, unit_counts)):
            blocks.append(BottleneckIRSE(cin, depth, 2, nx))
            blocks += [BottleneckIRSE(depth, depth, 1, nx) for _ in range(n_units - 1)]
            cin = depth
            if stage >= 1:
                taps.append(len(blocks) - 1)
        self.body = nn.Sequential(*blocks)
        self.tap_indices = tuple(taps)
        s_c3 = input_size // 16
        self.styles = nn.ModuleList()
        for h in range(n_styles):
            if h < coarse_ind:
                self.styles.append(GradualStyleBlock(depths[3], style_dim, s_c3, nx))
            elif h < middle_ind:
                self.styles.append(GradualStyleBlock(style_dim, style_dim, 2 * s_c3, nx))
            else:
                self.styles.append(GradualStyleBlock(style_dim, style_dim, 4 * s_c3, nx))
        self.latlayer1 = Conv2d(depths[2], style_dim, 1, nx=nx)
        self.latlayer2 = Conv2d(depths[1], style_dim, 1, nx=nx)

    @staticmethod
    def _upsample_add(x, y):
        return F.interpolate(x, size=y.shape[2:], mode="bilinear", align_corners=True) + y

    def forward(self, x):
        x = self.input_layer(x)
        taps = []
        for i, block in enumerate(self.body):
            x = block(x)
            if i in self.tap_indices:
                taps.append(x)
        c1, c2, c3 = taps
        w0 = self.styles[0](c3)
        rows = [w0]
        features, p2 = c3, None
        for i in range(1, self.n_styles):
            if i == self.coarse_ind:
                p2 = self._upsample_add(c3, self.latlayer1(c2))
                features = p2
            elif i == self.middle_ind:
                features = self._upsample_add(p2, self.latlayer2(c1))
            rows.append(w0 + self.styles[i](features))
        return torch.stack(rows, dim=1)


# ---------------------------------------------------------------------------
# VGG16 taps (the paper's vgg.py)
# ---------------------------------------------------------------------------

VGG_LAYERS = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128),
              ("conv2_2", 128, 128), ("conv3_1", 128, 256), ("conv3_2", 256, 256),
              ("conv3_3", 256, 256), ("conv4_1", 256, 512), ("conv4_2", 512, 512))


class VGG16Taps(nn.Module):
    """(relu conv1_1, relu conv1_2, pool2 output, relu conv4_2); the input in
    [-1, 1], not normalised; pool3 in ceil mode."""

    def __init__(self, nx: Numerics = FLOAT32):
        super().__init__()
        for name, cin, cout in VGG_LAYERS:
            self.add_module(name, Conv2d(cin, cout, 3, 1, 1, nx=nx))

    def forward(self, x):
        c = lambda name, t: F.relu(getattr(self, name)(t))  # noqa: E731
        t1 = c("conv1_1", x)
        t2 = c("conv1_2", t1)
        out = F.max_pool2d(t2, 2, 2)
        out = F.max_pool2d(c("conv2_2", c("conv2_1", out)), 2, 2)
        t3 = out
        out = c("conv3_3", c("conv3_2", c("conv3_1", out)))
        out = F.max_pool2d(out, 2, 2, ceil_mode=True)
        t4 = c("conv4_2", c("conv4_1", out))
        return t1, t2, t3, t4


def avg_pool(x, factor: int):
    """The exact mean of each factor x factor window (NCHW)."""
    return x if factor == 1 else F.avg_pool2d(x, factor, factor)

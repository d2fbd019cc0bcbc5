"""Fused StyledConv — modulate + 3x3 conv + demodulate + noise + bias +
leaky-ReLU(sqrt 2) in one pass (port of ``tpufusion/ops/styled_conv.py``).

Kernel: ``csrc/styled_conv.cu``, replacing the TPU kernel
``tpufusion/ops/styled_conv.py::_pallas_styled_conv`` (``_kernel``). The
kernel reads x once and writes y once: modulation happens on the staged
input, demodulation, bias, noise and the activation before the store.
bfloat16 runs on the tensor cores (an implicit GEMM on wgmma with TMA
copies, ``csrc/conv3x3_wgmma.cuh``, shared with the conv3x3 forward),
float32 on the CUDA cores. The rounding points are the TPU kernel's: the modulated input
``x * bf16(s)`` is rounded to the activation dtype, the conv is summed in
float32, and the epilogue rounds once. Its bounds on an H100 are in the
source note; at C >= 128 it is operations-bound, at C = 32 / 1024^2
memory-bound.

The kernel is the CUDA implementation of the PyTorch operator
``tpufusion::styled_conv`` (``torch.library.custom_op``), whose CPU
implementation is the composite and whose fake implementation gives the
output's shape, so that ``torch.export`` traces the synthesis to one node
(``io/export.py``).

The backward of both styled operators is analytic where
``backward_takes_kernels`` says so (CUDA, bf16, the kernels' shapes, and a
gradient of x or the style only: every attack freezes the generator): two
kernels on the same wgmma body, K1 (the forward's conv again, whose
epilogue turns g = dL/dy into gc = dL/dc and sums dL/dsigma) and K2 (the
input grad of the conv with the style's epilogue), then a fixed-order sum
of their partials (``styled_conv_backward_launcher``; the math and the
design in ``csrc/styled_conv.cu``). ``styled_conv_backward_plain`` is its
plain twin. Every other backward (float32, the CPU, shapes K2 does not
take, gradients of the weights, bias or noise) is autograd of the
composite ``styled_conv_reference``, recomputed, as ``_fsc_bwd`` does in
JAX; on the card each such call counts ``styled_conv_bwd_composite``.

The TPU dispatcher's even-H/W and H >= 16 limits were artefacts of its row
tiling; this kernel takes every 3x3 styled conv with Cin % 16 == 0,
Cout % 32 == 0 and one shared ``(1, H, W, 1)`` noise plane, 4^2 and 8^2
included. Per-sample noise stays on the composite, as in JAX.

The upsampling styled conv has its own operator, ``tpufusion::styled_conv_up``
(``styled_conv_up``), with the blur folded into the weights
(``ops/modconv.py::fold_up_weight``): x (N, H, W, Cin) -> y (N, 2H, 2W,
Cout) is one "same" 3x3 conv to 4 Cout phase channels at the input plane.
Its bf16 kernel (``styled_conv_up_wgmma_kernel``, the same wgmma body as the
styled conv's) modulates the staged input, applies sigma (of the unfolded
weight), bias, the noise of each output pixel and the activation, and
stores each phase channel at its depth-to-space place: x read once, y
written once. Other shapes, per-sample noise and the CPU run the composite
``styled_conv_up_reference`` (bf16: folded; float32: the unfolded chain,
``ops/modconv.py``); its backward is the same two kernels on the phase
weights, or autograd of that composite, recomputed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpufusion_torch.core import trace
from tpufusion_torch.ops import _lib, conv3x3
from tpufusion_torch.ops.modconv import (
    depth_to_space,
    fold_up_weight,
    modulated_conv2d,
    modulated_conv2d_up_plain,
    space_to_depth,
)

SQRT2 = math.sqrt(2.0)


def noise_bias_act(y, noise, noise_strength, bias):
    """The styled-conv epilogue: noise injection + bias + leaky-ReLU * sqrt2
    (rosinality ``NoiseInjection`` then ``FusedLeakyReLU``)."""
    y = y + noise_strength.to(y.dtype) * noise.to(y.dtype)
    return F.leaky_relu(y + bias.to(y.dtype), 0.2) * SQRT2


def styled_conv_reference(x, weight, style, noise, noise_strength, bias):
    """The composite: ``modulated_conv2d`` + ``noise_bias_act`` (also the
    backward's recompute)."""
    y = modulated_conv2d(x, weight, style, demodulate=True, up=False)
    return noise_bias_act(y, noise, noise_strength, bias)


def styled_conv_plain(x, weight, style, noise, noise_strength, bias):
    """The kernel's function in plain PyTorch only (``F.conv2d``, no kernel
    on any device): the twin the kernel is held against."""
    cin = x.shape[-1]
    scale = 1.0 / math.sqrt(9 * cin)
    xs = x * style.to(x.dtype)[:, None, None, :]
    w = (weight * scale).to(x.dtype)
    y = F.conv2d(xs.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    w2 = ((weight.float() * scale) ** 2).sum(dim=(0, 1))
    sigma = torch.rsqrt(style.float() ** 2 @ w2 + 1e-8)
    return noise_bias_act(y * sigma[:, None, None, :].to(y.dtype), noise,
                          noise_strength, bias)


def supported(x_shape, w_shape, noise_shape) -> bool:
    """Shapes the kernel takes: 3x3, Cin % 16 == 0, Cout % 32 == 0 and one
    shared (1, H, W, 1) noise plane."""
    kh, kw, cin, cout = w_shape
    n, h, w, c = x_shape
    return ((kh, kw) == (3, 3) and cin == c and cin % 16 == 0 and cout % 32 == 0
            and tuple(noise_shape) == (1, h, w, 1))


def _check(what, ok, x, weight, style, noise, noise_strength, bias):
    """Raise on what a styled kernel does not take (``ok``: its shape test),
    a style, bias or noise strength that does not match x and the weights,
    a non-contiguous x, then tensors off the card (so that each condition
    raises on the CPU too)."""
    if x.dim() != 4 or not ok:
        raise ValueError(f"{what}: unsupported shapes or dtype x {tuple(x.shape)} {x.dtype}, "
                         f"w {tuple(weight.shape)}, noise {tuple(noise.shape)}")
    if (tuple(style.shape) != (x.shape[0], x.shape[3]) or tuple(bias.shape) != (weight.shape[3],)
            or noise_strength.numel() != 1):
        raise ValueError(f"{what}: style {tuple(style.shape)} / bias {tuple(bias.shape)} / "
                         f"noise_strength {tuple(noise_strength.shape)} do not match x and w")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous (N,H,W,C)")
    _check_cuda(what, x, weight=weight, style=style, noise=noise, noise_strength=noise_strength,
                bias=bias)


def _check_cuda(what, x, **others):
    if not x.is_cuda:
        raise ValueError(f"{what}: x must be a CUDA tensor, got {x.device}")
    for name, t in others.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")


def _noise_plane(noise, noise_strength, h, w, up):
    """The pre-scaled noise the kernels read: (H, W) of x's plane, or for
    the up conv (noise (1, 2H, 2W, 1)) (H, W, 4), each input pixel's four
    output pixels, phase 2 a + b at (2 i + a, 2 j + b)."""
    if not up:
        return (noise_strength.float() * noise.reshape(h, w).float()).contiguous()
    noise4 = (noise_strength.float() * noise.reshape(h, 2, w, 2).float()).permute(0, 2, 1, 3)
    return noise4.contiguous()


def _scaled_weights_and_sigma(weight, style):
    """The equalised-lr weights in float32, their squares summed over the
    taps (Cin, Cout) and sigma (N, Cout) of them."""
    ws = weight.float() * (1.0 / math.sqrt(9 * weight.shape[2]))
    w2 = ws.square().sum(dim=(0, 1))
    return ws, w2, torch.rsqrt(style.float().square() @ w2 + 1e-8)


def styled_conv_launcher(x, weight, style, noise, noise_strength, bias):
    """Check the inputs, prepare what the kernel reads and return its launch
    (``launch() -> y``, one kernel, y allocated anew). The preparation is
    ``_pallas_styled_conv``'s around its kernel: the scaled weights (bf16:
    packed for the tile class, ``conv3x3.mma_class``), sigma in float32 and
    the pre-scaled noise plane. Every check runs before the library is
    built or loaded. ``styled_conv_kernel`` calls the launch once;
    ``chip_smoke.py`` times it apart from the preparation."""
    _check("styled_conv", x.dim() == 4 and supported(x.shape, weight.shape, noise.shape),
           x, weight, style, noise, noise_strength, bias)
    n, h, w, cin = x.shape
    cout = weight.shape[3]
    code = _lib.dtype_code(x)
    fn = _lib.load("styled_conv").tf_styled_conv_fwd
    # few device ops here: at the 4^2-32^2 planes the host's time per op,
    # not the kernel, sets the call's time
    ws, _, sigma = _scaled_weights_and_sigma(weight, style)
    noise2d = _noise_plane(noise, noise_strength, h, w, up=False)
    # float32 style (the bf16 kernel rounds it to bf16) and bias
    s32, b = style.float().contiguous(), bias.float().contiguous()
    cls = 0
    if x.dtype == torch.bfloat16:
        # the TMA reads x from a 16-byte aligned base; its NHWC strides are
        # Cin * 2 bytes, a multiple of 16 (``supported``)
        x, s32, b = (_lib.aligned16(t) for t in (x, s32, b))
        picked = conv3x3.mma_class(n, h, w, cin, cout)
        w_k, cls = conv3x3.pack_mma_weights(ws, picked, x.dtype), picked.code
    else:
        w_k = ws.contiguous()  # HWIO; a module's weight may be a permuted view
    bufs = (x, w_k, s32, sigma.contiguous(), b, noise2d)
    x_p, w_p, *rest = (t.data_ptr() for t in bufs)

    def launch():
        y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
        _lib.launch(fn, x, "styled_conv", x_p, w_p, y.data_ptr(), *rest,
                    n, h, w, cin, cout, code, cls)
        return y
    launch.buffers = bufs  # alive as long as the launch: the pointers name them
    return launch


def styled_conv_kernel(x, weight, style, noise, noise_strength, bias):
    """Launch the fused kernel once (``styled_conv_launcher``)."""
    return styled_conv_launcher(x, weight, style, noise, noise_strength, bias)()


# ``tpufusion::styled_conv``: the kernel as a PyTorch operator, so that
# ``torch.export`` traces the synthesis to one graph node (the ctypes launch
# reads ``data_ptr()``, which a FakeTensor does not have) and the serving
# process that loads the program runs this kernel.
@torch.library.custom_op("tpufusion::styled_conv", mutates_args=(), device_types="cuda")
def styled_conv_op(x: torch.Tensor, weight: torch.Tensor, style: torch.Tensor,
                   noise: torch.Tensor, noise_strength: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """The fused kernel on CUDA tensors (one launch, counted)."""
    y = styled_conv_kernel(x.contiguous(), weight, style, noise, noise_strength, bias)
    trace.count("styled_conv")
    return y


@styled_conv_op.register_kernel("cpu")
def _styled_conv_cpu(x, weight, style, noise, noise_strength, bias):
    # CPU tensors: the composite, the numbers the port gave before the op
    return styled_conv_reference(x, weight, style, noise, noise_strength, bias)


@styled_conv_op.register_fake
def _styled_conv_fake(x, weight, style, noise, noise_strength, bias):
    return x.new_empty(tuple(x.shape[:3]) + (weight.shape[3],))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _recomputed_backward(reference, ctx, g):
    """Autograd of the composite ``reference``, recomputed from the saved
    inputs (JAX's ``_fsc_bwd``): the backward wherever the kernels do not
    take it."""
    need = ctx.needs_input_grad
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(nd) for t, nd in zip(ctx.saved_tensors, need)]
        y = reference(*inputs)
        wrt = [t for t, nd in zip(inputs, need) if nd]
        grads = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
    return tuple(next(grads) if nd else None for nd in need)


def _backward(up):
    """An operator's backward: the two kernels where
    ``backward_takes_kernels`` says so, else the recomputed composite."""
    reference = styled_conv_up_reference if up else styled_conv_reference

    def backward(ctx, g):
        x, weight, style, noise, noise_strength, bias = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not backward_takes_kernels(need, x.device.type, x.dtype, x.shape, weight.shape,
                                      noise.shape, up):
            if x.is_cuda:
                trace.count("styled_conv_bwd_composite")
            return _recomputed_backward(reference, ctx, g)
        gx, gs = styled_conv_backward_launcher(x.contiguous(), weight, style, noise,
                                               noise_strength, bias, g.contiguous(), up=up,
                                               need_x=need[0])()
        trace.count("styled_conv_up_bwd" if up else "styled_conv_bwd")
        return gx, None, gs.to(style.dtype) if need[2] else None, None, None, None
    return backward


styled_conv_op.register_autograd(_backward(False), setup_context=_setup_context)


def styled_conv(x, weight, style, noise, noise_strength, bias):
    """Non-upsampling styled conv. Shapes the kernel does not take run the
    composite; the rest go through ``tpufusion::styled_conv``, which
    launches the kernel on CUDA tensors (or raises) and runs the composite
    on CPU tensors."""
    if not supported(x.shape, weight.shape, noise.shape):
        return styled_conv_reference(x, weight, style, noise, noise_strength, bias)
    if x.device.type not in ("cpu", "cuda"):
        # the operator has no implementation there: the launch's checks raise
        return styled_conv_kernel(x.contiguous(), weight, style, noise, noise_strength, bias)
    return styled_conv_op(x, weight, style, noise, noise_strength, bias)


# ---- the upsampling styled conv ----------------------------------------------
# the blur taps the up operator folds (rosinality's); a generator with other
# taps runs the composite with its own
UP_TAPS = (1, 3, 3, 1)


def styled_conv_up_reference(x, weight, style, noise, noise_strength, bias):
    """The composite: ``modulated_conv2d(up=True)`` (bf16: folded, one same
    conv on the phase weights, depth-to-space, demodulation) +
    ``noise_bias_act`` (also the backward's recompute)."""
    y = modulated_conv2d(x, weight, style, demodulate=True, up=True, blur_taps=UP_TAPS)
    return noise_bias_act(y, noise, noise_strength, bias)


def styled_conv_up_plain(x, weight, style, noise, noise_strength, bias):
    """The up conv unfolded, as rosinality runs it (transposed conv, blur,
    demodulation) + the epilogue: the twin the fold is held against."""
    y = modulated_conv2d_up_plain(x, weight, style, blur_taps=UP_TAPS)
    return noise_bias_act(y, noise, noise_strength, bias)


def up_supported(x_shape, w_shape, noise_shape, dtype) -> bool:
    """What the up kernel takes: bf16, 3x3, Cin % 16 == 0, 4 Cout % 32 == 0
    (the phase conv's Cout) and one shared (1, 2H, 2W, 1) noise plane."""
    kh, kw, cin, cout = w_shape
    n, h, w, c = x_shape
    return (dtype == torch.bfloat16 and (kh, kw) == (3, 3) and cin == c and cin % 16 == 0
            and (4 * cout) % 32 == 0 and tuple(noise_shape) == (1, 2 * h, 2 * w, 1))


def styled_conv_up_launcher(x, weight, style, noise, noise_strength, bias):
    """As ``styled_conv_launcher``, for the up kernel: checks, then the
    scaled weights folded into the (3, 3, Cin, 4 Cout) phase weights and
    packed for the tile class of that conv (``conv3x3.mma_class(n, h, w,
    cin, 4 cout)``), sigma of the unfolded weights, and the pre-scaled
    noise plane as (H, W, 4): each input pixel's four output pixels, phase
    2 a + b at (2 i + a, 2 j + b). Returns ``launch() -> y`` (N, 2H, 2W,
    Cout)."""
    _check("styled_conv_up",
           x.dim() == 4 and up_supported(x.shape, weight.shape, noise.shape, x.dtype),
           x, weight, style, noise, noise_strength, bias)
    n, h, w, cin = x.shape
    cout = weight.shape[3]
    fn = _lib.load("styled_conv").tf_styled_conv_up_fwd
    ws, _, sigma = _scaled_weights_and_sigma(weight, style)
    w4, _ = fold_up_weight(ws, UP_TAPS)
    noise4 = _noise_plane(noise, noise_strength, h, w, up=True)
    x, s32, b = (_lib.aligned16(t) for t in (x, style.float().contiguous(),
                                             bias.float().contiguous()))
    picked = conv3x3.mma_class(n, h, w, cin, 4 * cout)
    w_k = conv3x3.pack_mma_weights(w4, picked, x.dtype)
    bufs = (x, w_k, s32, sigma.contiguous(), b, noise4)
    x_p, w_p, *rest = (t.data_ptr() for t in bufs)

    def launch():
        y = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
        _lib.launch(fn, x, "styled_conv_up", x_p, w_p, y.data_ptr(), *rest,
                    n, h, w, cin, cout, picked.code)
        return y
    launch.buffers = bufs
    return launch


def styled_conv_up_kernel(x, weight, style, noise, noise_strength, bias):
    """Launch the fused up kernel once (``styled_conv_up_launcher``)."""
    return styled_conv_up_launcher(x, weight, style, noise, noise_strength, bias)()


@torch.library.custom_op("tpufusion::styled_conv_up", mutates_args=(), device_types="cuda")
def styled_conv_up_op(x: torch.Tensor, weight: torch.Tensor, style: torch.Tensor,
                      noise: torch.Tensor, noise_strength: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """The fused up kernel on CUDA tensors (one launch, counted)."""
    y = styled_conv_up_kernel(x.contiguous(), weight, style, noise, noise_strength, bias)
    trace.count("styled_conv_up")
    return y


@styled_conv_up_op.register_kernel("cpu")
def _styled_conv_up_cpu(x, weight, style, noise, noise_strength, bias):
    return styled_conv_up_reference(x, weight, style, noise, noise_strength, bias)


@styled_conv_up_op.register_fake
def _styled_conv_up_fake(x, weight, style, noise, noise_strength, bias):
    n, h, w, _ = x.shape
    return x.new_empty((n, 2 * h, 2 * w, weight.shape[3]))


styled_conv_up_op.register_autograd(_backward(True), setup_context=_setup_context)


def styled_conv_up(x, weight, style, noise, noise_strength, bias):
    """Upsampling styled conv (taps ``UP_TAPS``). What the kernel does not
    take (``up_supported``: float32, per-sample noise, other shapes) runs
    the composite; the rest goes through ``tpufusion::styled_conv_up``,
    which launches the kernel on CUDA tensors (or raises) and runs the
    composite on CPU tensors."""
    if not up_supported(x.shape, weight.shape, noise.shape, x.dtype):
        return styled_conv_up_reference(x, weight, style, noise, noise_strength, bias)
    if x.device.type not in ("cpu", "cuda"):
        return styled_conv_up_kernel(x.contiguous(), weight, style, noise, noise_strength, bias)
    return styled_conv_up_op(x, weight, style, noise, noise_strength, bias)


# ---- the backward of both styled convs ---------------------------------------
def styled_conv_backward_plain(x, weight, style, noise, noise_strength, bias, g, *, up=False,
                               positive=None):
    """The analytic backward of the styled conv (``up``: of the folded up
    conv) in plain PyTorch, with the kernels' rounding points: what K1 and
    K2 compute, the twin they are held against. With c = conv(x s, W) (up:
    the phase conv, depth-to-space), sigma = rsqrt(s^2 W2 + 1e-8), W2 the
    squared weights summed over the taps, z = c sigma + bias + ns noise and
    y = sqrt2 lrelu(z, 0.2):

        gz = g sqrt2 (z > 0 ? 1 : 0.2),  gc = gz sigma,  gsigma = sum_hw gz c,
        gxs = dgrad(gc, W),  gx = gxs s,
        gs = sum_hw gxs x - s (W2 . (sigma^3 gsigma)).

    ``positive``, where given, takes the place of z > 0: the forward
    kernel's y > 0, so that at the kink the twin follows the kernels' own
    float32 z (K1 re-runs the forward's conv and epilogue arithmetic)
    rather than its own, summed in another order.

    Returns (gx in x's dtype, gs in the style's). The sums run in float32
    (float64 for float64 inputs); x s, the weights and gc are rounded to
    x's dtype, as the kernels round them."""
    f = torch.promote_types(x.dtype, torch.float32)
    ws, w2, sigma = _scaled_weights_and_sigma(weight, style)
    wk = fold_up_weight(ws, UP_TAPS)[0] if up else ws
    wk = wk.to(x.dtype).to(f)
    s = style.to(x.dtype)
    c = conv3x3.conv3x3_plain((x * s[:, None, None, :]).to(f), wk)
    if up:
        c = depth_to_space(c)
    sig = sigma.to(f)[:, None, None, :]
    if positive is None:
        positive = c * sig + bias.to(f) + noise_strength.to(f) * noise.to(f) > 0
    gz = g.to(f) * torch.where(positive, SQRT2, 0.2 * SQRT2)
    gsig = (gz * c).sum(dim=(1, 2))
    gc = (gz * sig).to(x.dtype).to(f)
    if up:
        gc = space_to_depth(gc)
    gxs = conv3x3.conv3x3_plain(gc, wk.flip(0, 1).transpose(2, 3))
    gx = (gxs * s.to(f)[:, None, None, :]).to(x.dtype)
    gs = (gxs * x.to(f)).sum(dim=(1, 2)) - style.to(f) * ((sigma.to(f) ** 3 * gsig) @ w2.to(f).t())
    return gx, gs.to(style.dtype)


def backward_takes_kernels(need, device_type, dtype, x_shape, w_shape, noise_shape, up) -> bool:
    """Whether a styled operator's backward runs the two kernels (else the
    recomputed composite): tensors on the card in bf16, the forward
    kernel's shapes (``supported`` / ``up_supported``), K2's (its output
    channels are the forward's Cin: Cin % 32 == 0), and no gradient asked
    of the weights, the noise, its strength or the bias. ``need`` is
    ``ctx.needs_input_grad`` of (x, weight, style, noise, noise_strength,
    bias)."""
    if device_type != "cuda" or dtype != torch.bfloat16 or any(need[i] for i in (1, 3, 4, 5)):
        return False
    fwd = (up_supported(x_shape, w_shape, noise_shape, dtype) if up
           else supported(x_shape, w_shape, noise_shape))
    return fwd and x_shape[-1] % 32 == 0


def styled_conv_backward_launcher(x, weight, style, noise, noise_strength, bias, g, *, up,
                                  need_x=True):
    """Check the inputs, prepare what the backward's two kernels read and
    return their launch (``launch() -> (gx, gs)``: gx (N, H, W, Cin) in
    x's dtype, None where ``need_x`` is false; gs (N, Cin) float32). The
    preparation: the scaled weights (up: folded into the phase weights, Cg
    = 4 Cout channels; else Cg = Cout) packed for K1's tile class
    (``conv3x3.mma_class(n, h, w, Cin, Cg)``), the same flipped and
    channel-transposed packed for K2's (``mma_class(n, h, w, Cg, Cin)``),
    sigma, W2 and the pre-scaled noise. After the kernels, a fixed-order sum
    of their per-tile partials (``torch.sum`` over a fixed shape, no
    atomics) gives dL/dsigma and sum_hw gxs x, and gs = that sum - s (W2 .
    (sigma^3 dL/dsigma)). Every check runs before the library is built or
    loaded; ``styled_conv_backward_kernel`` calls the launch once."""
    what = "styled_conv_up backward" if up else "styled_conv backward"
    ok = x.dim() == 4 and backward_takes_kernels((need_x, False, True, False, False, False),
                                                 "cuda", x.dtype, x.shape, weight.shape,
                                                 noise.shape, up)
    if ok:
        n, h, w, _ = x.shape
        want = (n, 2 * h, 2 * w, weight.shape[3]) if up else (n, h, w, weight.shape[3])
        if tuple(g.shape) != want or g.dtype != x.dtype or not g.is_contiguous():
            raise ValueError(f"{what}: g {tuple(g.shape)} {g.dtype} must be a contiguous "
                             f"{want} {x.dtype}")
    _check(what, ok, x, weight, style, noise, noise_strength, bias)
    _check_cuda(what, x, g=g)
    n, h, w, cin = x.shape
    cout = weight.shape[3]
    lib = _lib.load("styled_conv")
    ws, w2, sigma = _scaled_weights_and_sigma(weight, style)
    wk = fold_up_weight(ws, UP_TAPS)[0] if up else ws
    noise_k = _noise_plane(noise, noise_strength, h, w, up)
    cg = wk.shape[3]
    k1, k2 = conv3x3.mma_class(n, h, w, cin, cg), conv3x3.mma_class(n, h, w, cg, cin)
    packed1 = conv3x3.pack_mma_weights(wk, k1, x.dtype)
    packed2 = conv3x3.pack_mma_weights(wk.flip(0, 1).transpose(2, 3), k2, x.dtype)
    x, g, s32, b = (_lib.aligned16(t) for t in (x, g, style.float().contiguous(),
                                                bias.float().contiguous()))
    sigma = sigma.contiguous()
    bufs = (x, g, s32, b, sigma, noise_k, packed1, packed2)
    x_p, g_p, s_p, b_p, sig_p, nz_p, pk1_p, pk2_p = (t.data_ptr() for t in bufs)
    rows1 = k1.tiles(n, h, w) * 4 * k1.team_wgs  # a partial row a consumer warp a tile
    rows2 = k2.tiles(n, h, w) * 4 * k2.team_wgs

    def launch():
        gc = torch.empty((n, h, w, cg), dtype=x.dtype, device=x.device)
        p1 = torch.empty((rows1, cg), dtype=torch.float32, device=x.device)
        _lib.launch(lib.tf_styled_conv_bwd, x, what, x_p, pk1_p, g_p, gc.data_ptr(), s_p, sig_p,
                    b_p, nz_p, p1.data_ptr(), n, h, w, cin, cout, int(up), k1.code)
        gx = torch.empty_like(x) if need_x else None
        p2 = torch.empty((rows2, cin), dtype=torch.float32, device=x.device)
        _lib.launch(lib.tf_styled_conv_dgrad, x, what, gc.data_ptr(), pk2_p, x_p,
                    None if gx is None else gx.data_ptr(), s_p, p2.data_ptr(), n, h, w, cg, cin,
                    k2.code)
        gsig = p1.view(n, -1, cg).sum(dim=1)
        if up:
            gsig = gsig.view(n, 4, cout).sum(dim=1)
        gs = p2.view(n, -1, cin).sum(dim=1) - s32 * ((sigma ** 3 * gsig) @ w2.t())
        return gx, gs
    launch.buffers = bufs
    return launch


def styled_conv_backward_kernel(x, weight, style, noise, noise_strength, bias, g, *, up=False,
                                need_x=True):
    """Launch the backward's two kernels once (``styled_conv_backward_launcher``)."""
    return styled_conv_backward_launcher(x, weight, style, noise, noise_strength, bias, g, up=up,
                                         need_x=need_x)()

"""Low-channel 3x3 SAME stride-1 convolution (port of
``tpufusion/ops/pallas_conv.py``).

The StyleGAN2 synthesis tail convs (Cin = Cout = 32 at 1024^2, 64 at 512^2)
as a ``torch.autograd.Function`` whose forward, input grad and weight grad
are hand-written kernels (``csrc/conv3x3.cu``), replacing
``pallas_conv.py::_conv3x3_wp_fwd_impl`` (forward and input grad) and
``::_conv3x3_wp_dw_impl`` (weight grad). On an H100 these convs are bound by
the bytes they move (see the source note in ``csrc/conv3x3.cu``). In
bfloat16 all three run on the tensor cores (the weight grad as a GEMM over
pixels, ``conv3x3_wgrad_mma_kernel``); float32 runs CUDA-core kernels that
keep exact float32 products. The TPU's 128-lane width packing
(``pack_weights``/``unpack_dw``) is not ported: it existed for the TPU's
matrix unit.

The input grad is the forward kernel on the flipped, channel-transposed
weights, as ``_wp_bwd`` does. The weight-grad kernel launches only when the
weights need a gradient; the attack freezes them, so its path never does.

Tensors: x (N, H, W, C) NHWC contiguous, w (3, 3, C, C) HWIO, C in {32, 64},
float32 or bfloat16. ``conv3x3_plain`` (``F.conv2d`` and its autograd) is
the same function; the wrapper uses it for CPU tensors only.
``conv3x3_input_grad_plain`` and ``conv3x3_weight_grad_plain`` repeat the
two gradient kernels' arithmetic in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpufusion_torch.ops import _lib

CHANNELS = (32, 64)
# weight-grad blocks (one partial sum each) per SM: the bf16 kernel's shared
# memory and registers leave room for one, the float32 kernel runs two
WGRAD_BLOCKS_PER_SM = {torch.bfloat16: 1, torch.float32: 2}


def supported(x_shape, w_shape) -> bool:
    """Shapes the kernels take (``pallas_conv.py::_supported``'s channel set;
    no width or row-count limits here)."""
    kh, kw, cin, cout = w_shape
    return (kh, kw) == (3, 3) and cin == cout == x_shape[-1] and cin in CHANNELS


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, NHWC x, HWIO w, via ``F.conv2d`` (differentiable)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_input_grad_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input grad as the kernel computes it: the forward conv of g with the
    flipped, channel-transposed weights."""
    return conv3x3_plain(g, w.flip(0, 1).transpose(2, 3))


def conv3x3_weight_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight grad as the kernel computes it: for each tap, the shifted input
    against g, summed over batch and pixels, in float32. (3, 3, C, C)."""
    n, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    g32 = g.float()
    return torch.stack([
        torch.stack([torch.einsum("nhwc,nhwd->cd", xp[:, ky:ky + h, kx:kx + w], g32)
                     for kx in range(3)])
        for ky in range(3)])


def _check(x, w, what):
    if not x.is_cuda or not w.is_cuda or x.device != w.device:
        raise ValueError(f"{what}: x and w must be on one CUDA device")
    if x.dim() != 4 or not supported(x.shape, w.shape):
        raise ValueError(f"{what}: takes (N,H,W,C) x and (3,3,C,C) w with C in "
                         f"{CHANNELS}, got {tuple(x.shape)} and {tuple(w.shape)}")
    _lib.dtype_code(x)
    if w.dtype != x.dtype:
        raise TypeError(f"{what}: w dtype {w.dtype} != x dtype {x.dtype}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError(f"{what}: x and w must be contiguous (NHWC, HWIO)")


def conv3x3_forward_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: y = conv3x3(x, w)."""
    fn = _lib.load("conv3x3").tf_conv3x3_fwd
    _check(x, w, "conv3x3")
    if x.dtype == torch.bfloat16:
        x, w = _lib.aligned16(x), _lib.aligned16(w)
    n, h, wd, c = x.shape
    y = torch.empty_like(x)
    _lib.launch(fn, x, "conv3x3 forward", x.data_ptr(), w.data_ptr(), y.data_ptr(),
                n, h, wd, c, _lib.dtype_code(x))
    return y


def conv3x3_input_grad_kernel(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on flipped, channel-transposed weights:
    dx = conv3x3(g, flip(w)^T)."""
    w_t = w.flip(0, 1).transpose(2, 3).contiguous()
    return conv3x3_forward_kernel(g, w_t)


def conv3x3_weight_grad_kernel(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the weight-grad kernel: dw (3, 3, C, C) float32 summed over
    the batch and every pixel (bf16: tensor cores; float32: CUDA cores).
    The same inputs give the same bits on every launch."""
    fn = _lib.load("conv3x3").tf_conv3x3_wgrad
    c = x.shape[-1]
    if x.dim() != 4 or c not in CHANNELS:
        raise ValueError(f"conv3x3 wgrad: takes (N,H,W,C) with C in {CHANNELS}, "
                         f"got {tuple(x.shape)}")
    _lib.dtype_code(x)
    for name, t in (("x", x), ("g", g)):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"conv3x3 wgrad: {name} must be a contiguous CUDA tensor")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("conv3x3 wgrad: g must match x in shape, dtype and device")
    if x.numel() == 0:
        raise ValueError(f"conv3x3 wgrad: empty input {tuple(x.shape)}")
    if x.dtype == torch.bfloat16:
        x, g = _lib.aligned16(x), _lib.aligned16(g)
    n, h, wd, _ = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nblocks = WGRAD_BLOCKS_PER_SM[x.dtype] * sms  # the most the kernel launches
    partial = torch.empty((nblocks, 3, 3, c, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, c, c), dtype=torch.float32, device=x.device)
    _lib.launch(fn, x, "conv3x3 weight grad", x.data_ptr(), g.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), n, h, wd, c, nblocks, _lib.dtype_code(x))
    return dw


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = conv3x3_forward_kernel(x, w)
        conv3x3.launches_fwd += 1
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_input_grad_kernel(g, w)
            conv3x3.launches_dgrad += 1
        if ctx.needs_input_grad[1]:
            dw = conv3x3_weight_grad_kernel(x, g).to(w.dtype)
            conv3x3.launches_wgrad += 1
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME stride-1 conv, NHWC x, HWIO w, Cin = Cout in {32, 64}.
    CPU tensors take the plain version; CUDA tensors launch the kernels
    (forward here, input and weight grads in the backward) or raise."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    return _Conv3x3.apply(x, w)


conv3x3.launches_fwd = 0
conv3x3.launches_dgrad = 0
conv3x3.launches_wgrad = 0

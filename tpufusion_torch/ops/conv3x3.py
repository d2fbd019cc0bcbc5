"""Low-channel 3x3 SAME stride-1 convolution (port of
``tpufusion/ops/pallas_conv.py``).

The StyleGAN2 synthesis tail convs (Cin = Cout = 32 at 1024^2, 64 at 512^2)
as a ``torch.autograd.Function`` whose forward, input grad and weight grad
are hand-written kernels (``csrc/conv3x3.cu``), replacing
``pallas_conv.py::_conv3x3_wp_fwd_impl`` (forward and input grad) and
``::_conv3x3_wp_dw_impl`` (weight grad). On an H100 these convs are bound by
the bytes they move (see the source note in ``csrc/conv3x3.cu``). In
bfloat16 all three run on wgmma and TMA (forward and input grad on
``conv3x3_wgmma_kernel``; the weight grad, a GEMM over pixels, on
``conv3x3_wgrad_wgmma_kernel``); float32 runs CUDA-core kernels that keep
exact float32 products. The TPU's 128-lane width packing
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

The bf16 forward (shared with ``ops/styled_conv.py``) runs in one of the
tile classes of ``csrc/conv3x3_wgmma.cuh``: ``MMA_CLASSES`` mirrors that
table, ``mma_class`` picks one from the shapes, and ``pack_mma_weights``
lays the weights out for it (wgmma's K-major B layout, one block per
chunk, tap and k-step). The choice and the packing are plain Python, so
the CPU tests reach them. ``WGRAD_CLASSES`` mirrors the bf16 weight grad's
tile classes (``csrc/conv3x3_wgrad.cuh``), one per channel count.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpufusion_torch.core import trace
from tpufusion_torch.ops import _lib

CHANNELS = (32, 64)
# weight-grad blocks (one partial sum each) per SM: the bf16 kernel's ring
# and its four warpgroups fill an SM, the float32 kernel runs two
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


@dataclasses.dataclass(frozen=True)
class MmaClass:
    """One tile class of the bf16 forward, ``WgTile<TH, TW, WGS, TEAM_WGS,
    MT, BN, CK, STAGES, RESIDENT, MIN_BLOCKS>`` in ``csrc/conv3x3_wgmma.cuh``
    (``code``: its case in ``launch_conv3x3_wgmma``): TH x TW output pixels
    a tile, shared by ``team_wgs`` of the ``wgs`` consumer warpgroups, each
    ``mt`` wgmma m64 tiles; ``bn`` output channels a block, ``ck`` input
    channels a stage of the ``stages``-slot ring; the weights ``resident``
    in shared memory or streamed a chunk at a time."""

    name: str
    code: int
    th: int
    tw: int
    wgs: int
    team_wgs: int
    mt: int
    bn: int
    ck: int
    stages: int
    resident: bool
    min_blocks: int

    def chunks(self, cin: int) -> int:
        return -(-cin // self.ck)

    def smem_bytes(self, cin: int) -> int:
        """``WgTile::smem_bytes``: the aligned ring, the resident weights,
        the epilogue's staging rows and the barriers."""
        def up(b):
            return -(-b // 1024) * 1024
        x_slot = up((self.th + 2) * (self.tw + 2) * self.ck * 2)
        w_chunk = 9 * self.ck * self.bn * 2
        stage = x_slot if self.resident else up(x_slot + w_chunk)
        resident = up(self.chunks(cin) * w_chunk) if self.resident else 0
        out = 4 * self.wgs * 16 * (self.bn * 2 + 16)
        return 1024 + self.stages * stage + resident + out + (2 * self.stages + 1) * 8

    def tiles(self, n: int, h: int, w: int) -> int:
        """The M tiles of an (n, h, w) output plane."""
        return n * -(-h // self.th) * -(-w // self.tw)

    def blocks(self, n: int, h: int, w: int, cout: int) -> int:
        """Tiles times Cout slices: the blocks a launch would need to give
        every tile its own block."""
        return self.tiles(n, h, w) * (cout // self.bn)


#          name       code TH  TW wgs team MT  BN   CK stages resident blocks/SM
NARROW32 = MmaClass("narrow32", 0, 16, 16, 2, 1, 4, 32, 32, 8, True, 1)
NARROW64 = MmaClass("narrow64", 1, 8, 16, 2, 1, 2, 64, 64, 5, True, 1)
WIDE = MmaClass("wide", 2, 16, 16, 2, 2, 2, 128, 16, 4, False, 1)
MID = MmaClass("mid", 3, 8, 16, 2, 2, 1, 64, 32, 3, False, 1)
SMALL = MmaClass("small", 4, 8, 8, 1, 1, 1, 32, 32, 4, False, 2)
MMA_CLASSES = (NARROW32, NARROW64, WIDE, MID, SMALL)
MMA_SMEM_MAX = 232448  # sm_90: 227 KB of dynamic shared memory a block
MMA_MIN_BLOCKS = 80  # Wide / Mid only with this many blocks


def mma_class(n: int, h: int, w: int, cin: int, cout: int) -> MmaClass:
    """The bf16 forward's tile class for x (n, h, w, cin) -> y (..., cout),
    Cin % 16 == 0 and Cout % 32 == 0: Narrow for Cout 32 / 64 while all the
    weights fit in shared memory (the 1024^2 / 512^2 planes and conv3x3),
    Wide or Mid where Cout divides into their slices with at least
    ``MMA_MIN_BLOCKS`` blocks, Small for the rest (the 4^2-32^2 planes and
    ragged Cout)."""
    narrow = {32: NARROW32, 64: NARROW64}.get(cout)
    if narrow is not None and narrow.smem_bytes(cin) <= MMA_SMEM_MAX:
        return narrow
    for cls in (WIDE, MID):
        if cout % cls.bn == 0 and cls.blocks(n, h, w, cout) >= MMA_MIN_BLOCKS:
            return cls
    return SMALL


def pack_mma_weights(w: torch.Tensor, cls: MmaClass, dtype=torch.bfloat16) -> torch.Tensor:
    """HWIO weights (3, 3, Cin, Cout) in the bf16 forward's layout for
    ``cls``: [Cout / BN][chunks][9 taps][CK / 16 k-steps][2][BN / 8][8][8],
    i.e. for each (slice, chunk, tap, k-step) a 16 x BN block of B in
    wgmma's K-major layout without swizzle -- 8 x 8 core matrices (8 output
    channels x 8 input channels, input channels contiguous) of 128 bytes,
    the two along K ``16 * BN`` bytes apart. Input channels past Cin are
    zero. One copy (and a pad for a ragged Cin), contiguous also where ``w``
    already has ``dtype``."""
    _, _, cin, cout = w.shape
    chunks = cls.chunks(cin)
    w9 = w.reshape(9, cin, cout)
    if chunks * cls.ck != cin:
        w9 = F.pad(w9, (0, 0, 0, chunks * cls.ck - cin))
    v = w9.reshape(9, chunks, cls.ck // 16, 2, 8, cout // cls.bn, cls.bn // 8, 8)
    # (tap, chunk, ks, kg, k8, slice, ng, n8) -> (slice, chunk, tap, ks, kg, ng, n8, k8)
    return v.permute(5, 1, 0, 2, 3, 6, 7, 4).to(dtype=dtype, memory_format=torch.contiguous_format,
                                              copy=True)


@dataclasses.dataclass(frozen=True)
class WgradClass:
    """One tile class of the bf16 weight grad, ``WgradTile<C, TH, STAGES>``
    in ``csrc/conv3x3_wgrad.cuh``: C channels, TH x 16 pixel tiles, a ring
    of ``stages`` (haloed x tile, g tile) slots, one block a SM."""

    name: str
    c: int
    th: int
    stages: int
    tw = 16

    def smem_bytes(self) -> int:
        """``WgradTile::SMEM``: the alignment slack, the ring of aligned
        slots (x box, then g box) and the barriers."""
        def up(b):
            return -(-b // 1024) * 1024
        x_box = (self.th + 2) * (self.tw + 2) * self.c * 2
        stage = up(up(x_box) + self.th * self.tw * self.c * 2)
        return 1024 + self.stages * stage + 2 * self.stages * 8

    def tiles(self, n: int, h: int, w: int) -> int:
        """The pixel tiles of x (n, h, w, C): the most blocks a launch takes."""
        return n * -(-h // self.th) * -(-w // self.tw)


#                   name      C  TH stages
WGRAD_CLASSES = {32: WgradClass("wgrad32", 32, 32, 2), 64: WgradClass("wgrad64", 64, 16, 3)}


def _check_cuda(what, a, b, names="x and w"):
    if not a.is_cuda or not b.is_cuda or a.device != b.device:
        raise ValueError(f"{what}: {names} must be on one CUDA device")


def _check(x, w, what):
    """Raise on what the kernels do not take: shapes, dtypes, layout, then
    the device (so that each condition raises on the CPU too)."""
    if x.dim() != 4 or not supported(x.shape, w.shape):
        raise ValueError(f"{what}: takes (N,H,W,C) x and (3,3,C,C) w with C in "
                         f"{CHANNELS}, got {tuple(x.shape)} and {tuple(w.shape)}")
    _lib.dtype_code(x)
    if w.dtype != x.dtype:
        raise TypeError(f"{what}: w dtype {w.dtype} != x dtype {x.dtype}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError(f"{what}: x and w must be contiguous (NHWC, HWIO)")
    _check_cuda(what, x, w)


def _forward_launcher(x: torch.Tensor, w: torch.Tensor, what: str):
    """The forward kernel's launch on x and HWIO weights ``w`` (checked):
    a function of no arguments that allocates y and launches once. bf16
    packs the weights for the tile class first. Nothing is built or loaded
    before the caller's checks have passed."""
    n, h, wd, c = x.shape
    code = _lib.dtype_code(x)
    cls = 0
    if x.dtype == torch.bfloat16:
        # the TMA reads x from a 16-byte aligned base (NHWC strides are
        # C * 2 bytes, a multiple of 16 for C in CHANNELS)
        x = _lib.aligned16(x)
        picked = mma_class(n, h, wd, c, c)
        w, cls = pack_mma_weights(w, picked), picked.code
    fn = _lib.load("conv3x3").tf_conv3x3_fwd

    def launch():
        y = torch.empty_like(x)
        _lib.launch(fn, x, what, x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c, code,
                    cls)
        return y
    return launch


def conv3x3_forward_launcher(x: torch.Tensor, w: torch.Tensor):
    """Check x and w, prepare the weights and return the forward kernel's
    launch (``launch() -> y``): what ``conv3x3_forward_kernel`` calls once,
    and what ``chip_smoke.py`` times apart from the preparation."""
    _check(x, w, "conv3x3")
    return _forward_launcher(x, w, "conv3x3 forward")


def conv3x3_forward_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: y = conv3x3(x, w)."""
    return conv3x3_forward_launcher(x, w)()


def conv3x3_input_grad_launcher(g: torch.Tensor, w: torch.Tensor):
    """As ``conv3x3_forward_launcher``, for the input grad: the forward
    kernel on flipped, channel-transposed weights."""
    _check(g, w, "conv3x3 input grad")
    w_t = w.flip(0, 1).transpose(2, 3)
    if g.dtype == torch.float32:
        w_t = w_t.contiguous()
    return _forward_launcher(g, w_t, "conv3x3 input grad")


def conv3x3_input_grad_kernel(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on flipped, channel-transposed weights:
    dx = conv3x3(g, flip(w)^T)."""
    return conv3x3_input_grad_launcher(g, w)()


def conv3x3_weight_grad_launcher(x: torch.Tensor, g: torch.Tensor):
    """Check x and g and return the weight-grad kernel's launch (``launch()
    -> dw``, the kernel and its second pass): what
    ``conv3x3_weight_grad_kernel`` calls once, and what ``chip_smoke.py``
    times apart from the checks. Nothing is built or loaded before the
    checks have passed."""
    c = x.shape[-1]
    if x.dim() != 4 or c not in CHANNELS:
        raise ValueError(f"conv3x3 wgrad: takes (N,H,W,C) with C in {CHANNELS}, "
                         f"got {tuple(x.shape)}")
    _lib.dtype_code(x)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("conv3x3 wgrad: g must match x in shape, dtype and device")
    if x.numel() == 0:
        raise ValueError(f"conv3x3 wgrad: empty input {tuple(x.shape)}")
    for name, t in (("x", x), ("g", g)):
        if not t.is_contiguous():
            raise ValueError(f"conv3x3 wgrad: {name} must be contiguous")
    _check_cuda("conv3x3 wgrad", x, g, "x and g")
    fn = _lib.load("conv3x3").tf_conv3x3_wgrad
    n, h, wd, _ = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nblocks = WGRAD_BLOCKS_PER_SM[x.dtype] * sms  # the most the kernel launches
    if x.dtype == torch.bfloat16:
        # the TMA reads x and g from 16-byte aligned bases; a block (and its
        # partial) a tile at most
        x, g = _lib.aligned16(x), _lib.aligned16(g)
        nblocks = min(nblocks, WGRAD_CLASSES[c].tiles(n, h, wd))
    code = _lib.dtype_code(x)

    def launch():
        partial = torch.empty((nblocks, 3, 3, c, c), dtype=torch.float32, device=x.device)
        dw = torch.empty((3, 3, c, c), dtype=torch.float32, device=x.device)
        _lib.launch(fn, x, "conv3x3 weight grad", x.data_ptr(), g.data_ptr(),
                    partial.data_ptr(), dw.data_ptr(), n, h, wd, c, nblocks, code)
        return dw
    return launch


def conv3x3_weight_grad_kernel(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the weight-grad kernel: dw (3, 3, C, C) float32 summed over
    the batch and every pixel (bf16: wgmma; float32: CUDA cores). The same
    inputs give the same bits on every launch."""
    return conv3x3_weight_grad_launcher(x, g)()


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = conv3x3_forward_kernel(x, w)
        trace.count("conv3x3_fwd")
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_input_grad_kernel(g, w)
            trace.count("conv3x3_dgrad")
        if ctx.needs_input_grad[1]:
            dw = conv3x3_weight_grad_kernel(x, g).to(w.dtype)
            trace.count("conv3x3_wgrad")
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME stride-1 conv, NHWC x, HWIO w, Cin = Cout in {32, 64}.
    CPU tensors take the plain version; CUDA tensors launch the kernels
    (forward here, input and weight grads in the backward) or raise."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    return _Conv3x3.apply(x, w)

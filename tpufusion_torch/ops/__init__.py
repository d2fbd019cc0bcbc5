"""Ops: resampling, modulated conv, the masked patch composite and the four
hand-written Hopper kernels.

The kernel modules ``styled_conv``, ``conv3x3``, ``pgd_update`` and
``adam_update`` each hold a kernel wrapper (``fused_adam`` in
``adam_update``; the others share their module's name; ``styled_conv``
also ``styled_conv_up``, the upsampling styled conv) and its plain twin;
import the wrapper from its module (``from tpufusion_torch.ops.conv3x3
import conv3x3``). The wrappers' launch counts live in the counter table of
``core/trace.py``; the functions below read and set them.
"""

from tpufusion_torch.core import trace
from tpufusion_torch.ops import adam_update, conv3x3, pgd_update, styled_conv
from tpufusion_torch.ops.composite import masked_composite
from tpufusion_torch.ops.modconv import modulated_conv2d
from tpufusion_torch.ops.upfirdn2d import (
    blur,
    downsample_2x,
    make_blur_kernel,
    upfirdn2d,
    upsample_2x,
)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for k in trace.LAUNCHES:
        trace.LAUNCHES[k] = 0


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (a ``launch_counts``-keyed dict) to the counts: what a
    CUDA graph's replay launched (``core/graphs.py``)."""
    for k, n in delta.items():
        trace.count(k, n)


def launch_counts() -> dict:
    """Launch counts of every kernel wrapper since the last reset (the
    counter table of ``core/trace.py``)."""
    return dict(trace.LAUNCHES)


__all__ = [
    "adam_update", "add_launch_counts", "blur", "conv3x3", "downsample_2x", "launch_counts", "make_blur_kernel",
    "masked_composite", "modulated_conv2d", "pgd_update", "reset_launch_counts",
    "styled_conv", "upfirdn2d", "upsample_2x",
]

"""Ops: resampling, modulated conv, the masked patch composite and the four
hand-written Hopper kernels.

The kernel modules ``styled_conv``, ``conv3x3``, ``pgd_update`` and
``adam_update`` each hold a kernel wrapper (``fused_adam`` in
``adam_update``; the others share their module's name), its plain twin and
its launch count; import the wrapper from its module (``from
tpufusion_torch.ops.conv3x3 import conv3x3``).
"""

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
    styled_conv.styled_conv.launches = 0
    pgd_update.pgd_update.launches = 0
    adam_update.fused_adam.launches = 0
    c3 = conv3x3.conv3x3
    c3.launches_fwd = c3.launches_dgrad = c3.launches_wgrad = 0


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (a ``launch_counts``-keyed dict) to the counts: what a
    CUDA graph's replay launched (``core/graphs.py``)."""
    c3 = conv3x3.conv3x3
    styled_conv.styled_conv.launches += delta.get("styled_conv", 0)
    c3.launches_fwd += delta.get("conv3x3_fwd", 0)
    c3.launches_dgrad += delta.get("conv3x3_dgrad", 0)
    c3.launches_wgrad += delta.get("conv3x3_wgrad", 0)
    pgd_update.pgd_update.launches += delta.get("pgd_update", 0)
    adam_update.fused_adam.launches += delta.get("fused_adam", 0)


def launch_counts() -> dict:
    """Launch counts of every kernel wrapper since the last reset."""
    c3 = conv3x3.conv3x3
    return {
        "styled_conv": styled_conv.styled_conv.launches,
        "conv3x3_fwd": c3.launches_fwd,
        "conv3x3_dgrad": c3.launches_dgrad,
        "conv3x3_wgrad": c3.launches_wgrad,
        "pgd_update": pgd_update.pgd_update.launches,
        "fused_adam": adam_update.fused_adam.launches,
    }


__all__ = [
    "adam_update", "add_launch_counts", "blur", "conv3x3", "downsample_2x", "launch_counts", "make_blur_kernel",
    "masked_composite", "modulated_conv2d", "pgd_update", "reset_launch_counts",
    "styled_conv", "upfirdn2d", "upsample_2x",
]

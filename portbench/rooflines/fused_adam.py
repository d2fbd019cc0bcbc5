"""``fused_adam``'s kernel (``AdamOp``): one launch a step over the float32
pixels of the attacked images (N, S, S, 3). It reads x, g, mu and nu and
writes x, mu and nu (7 * 4 bytes a pixel, plus the 12 bytes of its
bias-correction row and step), 12 float32 operations a pixel."""

from portbench.peaks import bound_s
from portbench.rooflines import count

KERNEL = "AdamOp"


def cycle_bounds(config, use):
    size = config["generator"]["size"]
    numel = count(use["images"], config) * size * size * 3
    return [bound_s(7 * numel * 4 + 12, 12 * numel, "float32")]

"""``pgd_update``'s kernel (``PgdOp``): one launch a PGD step over the
float32 pixels of the attacked images (N, S, S, 3). It reads adv, the
gradient and the images and writes adv (4 * 4 bytes a pixel), 7 float32
operations a pixel (the arithmetic of ``chip_smoke.py``'s phase 3
and of PERF.md's kernel table, row 4)."""

from portbench.peaks import bound_s
from portbench.rooflines import count

KERNEL = "PgdOp"


def cycle_bounds(config, use):
    size = config["generator"]["size"]
    numel = count(use["images"], config) * size * size * 3
    return [bound_s(4 * numel * 4, 7 * numel, "float32")]

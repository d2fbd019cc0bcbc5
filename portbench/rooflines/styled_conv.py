"""``styled_conv``'s kernel (``conv3x3_wgmma_kernel<true, ...>``, the bf16
fused styled conv): one launch for each non-upsampling 3x3 styled conv of a
synthesis, at planes 4^2 ... size^2 in that order, batch N. Per launch it
reads x (N, H, W, Cin) and the weights once and writes y (N, H, W, Cout)
once, and does 2 * 9 * Cin * Cout * N * H * W operations (the arithmetic of
``chip_smoke.py``'s phase 3 and of PERF.md's kernel table)."""

from portbench.peaks import bound_s
from portbench.rooflines import count

KERNEL = "conv3x3_wgmma_kernel<true"
ISZ = 2  # bfloat16


def channel_map(size, channel_multiplier):
    c = channel_multiplier
    full = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * c, 128: 128 * c, 256: 64 * c,
            512: 32 * c, 1024: 16 * c}
    return {r: ch for r, ch in full.items() if r <= size}


def launch_bound(n, res, cin, cout):
    nbytes = n * res * res * (cin + cout) * ISZ + 9 * cin * cout * ISZ
    return bound_s(nbytes, 2 * 9 * cin * cout * n * res * res, "bfloat16")


def cycle_bounds(config, use):
    """``use["batch"]`` synthesis forwards' images a step."""
    n = count(use["batch"], config)
    g = config["generator"]
    return [launch_bound(n, res, ch, ch)
            for res, ch in sorted(channel_map(g["size"], g["channel_multiplier"]).items())]

"""The yardstick's arithmetic: kernel bounds, operation counts, shares.

- The copied roofline arithmetic gives PERF.md's bounds: styled_conv over
  the nine planes of the white-box synthesis (batch 5) 0.6272 ms and of the
  PGD synthesis (batch 1) 0.1281 ms, ``fused_adam`` at 5 x 1024^2 x 3
  0.1315 ms, ``pgd_update`` at 5 x 1024^2 x 3 0.0751 ms.
- The operation count on ``meta`` matches a count by hand for one styled
  conv and one IR-SE unit.
- A share cannot pass 100% while each launch takes at least its bound.
"""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, peaks, rooflines
from portbench.reference import models as ref
from portbench.trace import Trace


def _config(cell="ffhq1024.whitebox"):
    return harness.load_cell(cell)[2]


def test_styled_conv_bound_is_the_kernel_tables():
    cycle = rooflines.load("styled_conv").cycle_bounds(_config(), {"batch": "n_inputs"})
    assert len(cycle) == 9
    assert sum(cycle) * 1e3 == pytest.approx(0.6272, abs=5e-5)


def test_styled_conv_bound_at_batch_one_is_the_kernel_tables():
    # PERF.md's row "PGD: 9 planes, batch 1"
    cycle = rooflines.load("styled_conv").cycle_bounds(_config(), {"batch": 1})
    assert len(cycle) == 9
    assert sum(cycle) * 1e3 == pytest.approx(0.1281, abs=5e-5)


def test_pixel_update_bounds_are_the_kernel_tables():
    cfg = _config()
    adam = rooflines.load("fused_adam").cycle_bounds(cfg, {"images": "n_inputs"})
    assert adam == [pytest.approx(0.1315e-3, abs=5e-8)]
    # PERF.md's row 4, "spatial: 5 x 1024^2 x 3"
    pgd = rooflines.load("pgd_update").cycle_bounds(cfg, {"images": "n_inputs"})
    assert pgd == [pytest.approx(0.0751e-3, abs=5e-8)]


def test_car_planes():
    cycle = rooflines.load("styled_conv").cycle_bounds(_config("car512.whitebox"),
                                                       {"batch": "n_inputs"})
    assert len(cycle) == 8
    # PERF.md's car row: 0.3421 ms at batch 4
    assert sum(cycle) * 1e3 == pytest.approx(0.3421, abs=5e-5)


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_flops_of_one_styled_conv_by_hand():
    with torch.device("meta"):
        conv = ref.StyledConv(64, 128, 512, ref.FLOAT32).requires_grad_(False)
        x = torch.zeros(5, 64, 32, 32)
        w = torch.zeros(5, 512)
        noise = torch.zeros(1, 1, 32, 32)
    got = _flops(lambda: conv(x, w, noise))
    conv_ops = 2 * 9 * 64 * 128 * 5 * 32 * 32
    modulation = 2 * 5 * 512 * 64  # the style affine
    demod = 2 * 5 * 64 * 128  # style^2 @ sum_k w^2
    assert got == conv_ops + modulation + demod


def test_flops_of_one_ir_se_unit_by_hand():
    with torch.device("meta"):
        unit = ref.BottleneckIRSE(128, 256, 2, ref.FLOAT32).requires_grad_(False)
        x = torch.zeros(5, 128, 64, 64)
    got = _flops(lambda: unit(x))
    n, h = 5, 64
    c1 = 2 * 9 * 128 * 256 * n * h * h  # 3x3 at stride 1
    c2 = 2 * 9 * 256 * 256 * n * (h // 2) ** 2  # 3x3 at stride 2
    short = 2 * 128 * 256 * n * (h // 2) ** 2  # 1x1 at stride 2
    se = 2 * 2 * 256 * 16 * n  # two 1x1 convs on the pooled vector
    assert got == c1 + c2 + short + se


@pytest.mark.parametrize("cell", ["ffhq1024.whitebox", "car512.whitebox",
                                  "ffhq1024.fusion_pgd_arith"])
def test_group_flops_of_the_cells(cell):
    """``step_mfu``'s count of one group on ``meta`` at the cell's size:
    some 3.5 TFLOP a white-box iteration on FFHQ (e4e, synthesis and
    VGG16, forwards and input gradients), less at 512^2 and N = 4; a fusion
    PGD step has the white-box step's e4e over the N images but one
    synthesis at batch 1 and no VGG16, about half."""
    from portbench import flops

    _, _, config, mix, _ = harness.load_cell(cell)
    per_step = flops.group_flops(config, mix) / int(mix["steps"])
    lo, hi = {"ffhq1024.whitebox": (2.5e12, 5e12), "car512.whitebox": (1e12, 3.5e12),
              "ffhq1024.fusion_pgd_arith": (1.2e12, 2.4e12)}[cell]
    assert lo <= per_step <= hi, per_step


def test_input_gradient_counts_twice_the_forward_for_frozen_weights():
    with torch.device("meta"):
        conv = ref.Conv2d(32, 32, 3, 1, 1, bias=False).requires_grad_(False)
        x = torch.zeros(2, 32, 16, 16, requires_grad=True)
    fwd = _flops(lambda: conv(x))
    both = _flops(lambda: conv(x).sum().backward())
    assert both == 2 * fwd


class _Ctx:
    def __init__(self, config, mix, durations):
        self.config, self.mix = config, mix
        self.trace = Trace(kernels=[("void conv3x3_wgmma_kernel<true, 1>", float(i), d)
                                    for i, d in enumerate(durations)])


@pytest.mark.parametrize("slower", [1.0, 1.5, 3.0])
def test_share_stays_at_or_under_100_when_launches_take_their_bound(slower):
    cfg = _config()
    mix = {"per_step": {"styled_conv": {"batch": "n_inputs"}}}
    cycle = rooflines.load("styled_conv").cycle_bounds(cfg, mix["per_step"]["styled_conv"])
    share = rooflines.read("styled_conv", _Ctx(cfg, mix, [b * slower for b in cycle * 4]))
    assert share == pytest.approx(100.0 / slower)
    assert share <= 100.0 + 1e-9


def test_share_is_silent_on_a_partial_cycle_or_no_launch():
    cfg = _config()
    mix = {"per_step": {"styled_conv": {"batch": "n_inputs"}}}
    assert rooflines.read("styled_conv", _Ctx(cfg, mix, [1e-3] * 10)) is None
    assert rooflines.read("styled_conv", _Ctx(cfg, mix, [])) is None
    assert rooflines.read("fused_adam", _Ctx(cfg, mix, [1e-3] * 9)) is None


def test_peaks():
    assert peaks.bound_s(3.35e12, 0, "bfloat16") == 1.0
    assert peaks.bound_s(0, 989e12, "bfloat16") == 1.0
    assert math.isclose(peaks.bound_s(0, 67e12, "float32"), 1.0)

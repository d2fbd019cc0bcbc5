"""A float64 witness for the white-box check of ``chip_smoke.py`` phase 4.

Phase 4 runs a 3-iteration white-box attack (lr 1e-2) through a 32^2
pipeline on the card and on the CPU, both in float32, and holds the
adversarial pixels to 0.2 lr of each other. That only tests the kernels if
float32 rounding cannot move a pixel that far. Here the same attack runs on
the CPU in float32 and in float64 (every cast to float32 in the port made a
cast to float64, the weights and inputs widened), and in float64 from
inputs moved by a small step in random directions:

- at phase 4's inputs the float32 CPU run lands within phase 4's limits of
  the float64 one, and moving the inputs by 1e-6 (several float32 ulps at
  |x| ~ 1; the card's and the CPU's iterates differ by about that after two
  steps) moves no pixel by more than a quarter of the limit;
- at the inputs phase 4 used before (seed 4), moving them by 1e-7, about
  one float32 ulp, moves some pixel by more than 0.2 lr: the third Adam step
  of such a pixel changes by ~0.5 lr under a change that float32 rounding
  alone makes, so a float32 run could land either way there.
"""

import contextlib
import importlib.util
import os

import pytest
import torch

from tpufusion_torch.attacks.whitebox import (
    PRESET_ATTACK_MAIN, WhiteboxConfig, _make_loss, _make_ref, run_whitebox)
from tpufusion_torch.core.dtypes import Policy
from tpufusion_torch.pipeline import FusionPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAWS = 4  # random directions of the input change
FORMER_INPUT_SEED = 4


@contextlib.contextmanager
def _float64_casts():
    """Every ``Tensor.float()`` in the port returns float64 inside."""
    own = "float" in torch.Tensor.__dict__
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        if own:
            torch.Tensor.float = cast
        else:
            del torch.Tensor.float


@pytest.fixture(scope="module")
def setup():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cpu = FusionPipeline.create("ffhq", device="cpu", policy=Policy(), **smoke.SMALL_PIPELINE)
    wide = FusionPipeline.create("ffhq", device="cpu", policy=Policy(torch.float64),
                                 **smoke.SMALL_PIPELINE)
    for name in ("generator", "encoder", "vgg"):
        getattr(wide, name).load_state_dict(getattr(cpu, name).state_dict())
        getattr(wide, name).double()
    wide.latent_avg = cpu.latent_avg.double()
    cfg = WhiteboxConfig(lr=smoke.SMALL_WB_LR, n_iters=smoke.SMALL_WB_ITERS)
    return smoke, cpu, wide, cfg


def _mask(cpu, x, t):
    """Phase 4's pixels: those whose first-step gradient exceeds 1e-6."""
    xa = x.clone().requires_grad_(True)
    total, _ = _make_loss(cpu, PRESET_ATTACK_MAIN, per_image=True)(xa, _make_ref(cpu)(x, t))
    (g,) = torch.autograd.grad(total.sum(), xa)
    return g.abs() > 1e-6


def _float64_moves(wide, cfg, x, t, step):
    """The float64 run's pixel moves from ``x``, then from ``x`` moved by
    ``step`` in each of ``DRAWS`` seeded random directions."""
    gen = torch.Generator().manual_seed(9)
    starts = [x.double()] + [x.double() + step * torch.randn(x.shape, generator=gen,
                                                             dtype=torch.float64)
                             for _ in range(DRAWS)]
    with _float64_casts():
        moves = [run_whitebox(wide, s, t.double(), cfg)[0] - s for s in starts]
    assert moves[0].dtype == torch.float64
    return moves[0], moves[1:]


def _apart(a, b, mask):
    d = (a - b).abs()[mask]
    return d.max().item(), d.mean().item()


@pytest.fixture(scope="module")
def phase4(setup):
    smoke, cpu, wide, cfg = setup
    x, t = smoke.small_inputs(torch)
    base, moved = _float64_moves(wide, cfg, x, t, 1e-6)
    move32 = run_whitebox(cpu, x, t, cfg)[0].double() - x.double()
    return dict(lr=cfg.lr, mask=_mask(cpu, x, t), base=base, moved=moved, move32=move32)


def test_cpu_float32_white_box_tracks_float64(phase4):
    worst, mean = _apart(phase4["move32"], phase4["base"], phase4["mask"])
    print(f"float32 CPU vs float64: max {worst:.3e}, mean {mean:.3e} "
          f"(phase 4's limits {0.2 * phase4['lr']:.0e}, 1e-5)")
    assert worst <= 0.2 * phase4["lr"] and mean <= 1e-5


def test_phase4_white_box_is_well_conditioned(phase4):
    changes = [_apart(m, phase4["base"], phase4["mask"]) for m in phase4["moved"]]
    print("float64, inputs moved by 1e-6: largest pixel change "
          + ", ".join(f"{w:.3e} (mean {m:.3e})" for w, m in changes))
    assert max(w for w, _ in changes) <= 0.05 * phase4["lr"]


def test_former_phase4_inputs_flip_under_a_1e7_change(setup):
    smoke, cpu, wide, cfg = setup
    x, t = smoke.small_inputs(torch, FORMER_INPUT_SEED)
    base, moved = _float64_moves(wide, cfg, x, t, 1e-7)
    mask = _mask(cpu, x, t)
    changes = [_apart(m, base, mask) for m in moved]
    print(f"float64, seed {FORMER_INPUT_SEED}, inputs moved by 1e-7: largest pixel change "
          + ", ".join(f"{w:.3e} (mean {m:.3e})" for w, m in changes)
          + f"; {int(mask.sum())} pixels, limit {0.2 * cfg.lr:.0e}")
    assert max(w for w, _ in changes) > 0.2 * cfg.lr

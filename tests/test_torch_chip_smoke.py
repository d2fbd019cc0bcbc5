"""``chip_smoke.py``'s kernel check fails a kernel whose output is not finite.

The script's error helpers take ``torch`` as an argument and run on CPU
tensors, so they are checked here without a card.
"""

import importlib.util
import math
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf])
@pytest.mark.parametrize("tol", [0.0, 1e-3, 3e-2])
def test_non_finite_output_fails(smoke, bad, tol):
    ref = torch.ones(4, 4)
    got = ref.clone()
    got[1, 2] = bad
    err, rel = smoke._err(torch, got, ref)
    assert err == rel == math.inf
    assert not smoke._within(err, rel, tol)


def test_finite_output_is_held_to_tol(smoke):
    ref = torch.full((3,), 4.0)
    err, rel = smoke._err(torch, ref + torch.tensor([0.0, 0.02, 0.0]), ref)
    assert err == pytest.approx(0.02) and rel == pytest.approx(0.005)
    assert smoke._within(err, rel, 1e-2) and not smoke._within(err, rel, 1e-3)
    assert smoke._within(*smoke._err(torch, ref, ref), 0.0)


PTXAS = """\
ptxas info    : Compiling entry function '_ZN2tf24conv3x3_wgrad_mma_kernelINS_9WgradTileILi64ELi8ELi32ELi8ELi2EEEEEvPK13__nv_bfloat16S5_Pfiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 235 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2tf20conv3x3_wgrad_kernelIfEEvPKT_S3_Pfiiii' for 'sm_90a'
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 95 registers, used 1 barriers, 42496 bytes smem
ptxas info    : Compiling entry function '_ZN2tf18conv3x3_mma_kernelILb1ENS_7MmaTileILi16ELi16ELi32ELi32ELi8ELi1ELi2ELb1EEEEEvPK13__nv_bfloat16S5_PS3_PKfS8_S8_S8_iiiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 125 registers, used 1 barriers
"""


def test_ptxas_summary_names_the_tile_classes(smoke):
    assert smoke.ptxas_summary(PTXAS) == [
        ("conv3x3_wgrad_mma_kernel<WgradTile<64, 8, 32, 8, 2>>", 235, 0),
        ("conv3x3_wgrad_kernel<float>", 95, 20),
        ("conv3x3_mma_kernel<styled, MmaTile<16, 16, 32, 32, 8, 1, 2, 1>>", 125, 0)]


def test_profiler_groups_keep_the_weight_grad_kernels_apart(smoke):
    def group(key):
        return next((g for pat, g in smoke.KERNEL_NAMES if pat in key), "other kernels")

    assert group("void tf::conv3x3_wgrad_mma_kernel<tf::WgradTile<32, 16, 32, 8, 2> >("
                 "__nv_bfloat16 const*, ...)") == "conv3x3_wgrad bf16"
    assert group("void tf::conv3x3_wgrad_kernel<float>(float const*, ...)") == \
        "conv3x3_wgrad fp32"
    assert group("tf::sum_partials_kernel(float const*, float*, int, int)") == \
        "conv3x3_wgrad second pass"
    assert group("void tf::conv3x3_mma_kernel<false, tf::MmaTile<16, 16, 32, 32, 8, 1, 2, "
                 "true> >(...)") == "conv3x3_fwd/dgrad bf16"
    assert smoke.KERNEL_TOL[("conv3x3_wgrad", "bfloat16")] <= 1e-3 < smoke.TOL["bfloat16"]

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


def _record(kernel, path, ms, dtype="bfloat16", lib=None):
    return dict(kernel=kernel, case=f"{path} case", dtype=dtype, max_abs_err=1e-3, rel_err=1e-4,
                tol=3e-2, ok=True, ms=ms, plain_ms=2 * ms, library_ms=lib,
                conv_core_library_ms=None, bound_ms=ms / 4, bound_by="bytes", path=path)


def test_summarize_carries_the_spatial_run(smoke):
    """Three main paths: every kernel entry has each path's launches and per
    step launches, ``launches`` is their sum, and a kernel timed at a
    path's own shapes carries them under that path's name."""
    records = [_record("styled_conv", "pgd", 1.0), _record("styled_conv", "whitebox", 3.0),
               _record("styled_conv", "spatial", 3.5),
               _record("conv3x3_fwd", "pgd", 0.2, lib=0.25),
               _record("conv3x3_dgrad", "pgd", 0.2, lib=1.3),
               _record("conv3x3_wgrad", "pgd", 0.1, lib=0.3),
               _record("pgd_update", "pgd", 0.04, dtype="float32"),
               _record("pgd_update", "spatial", 0.1, dtype="float32"),
               _record("fused_adam", "whitebox", 0.15, dtype="float32", lib=0.17)]
    keys = ("styled_conv", "conv3x3_fwd", "conv3x3_dgrad", "conv3x3_wgrad", "pgd_update",
            "fused_adam")
    runs = {"pgd": (dict(zip(keys, (81, 12, 12, 0, 6, 0))), dict(zip(keys, (9, 2, 2, 0, 1, 0)))),
            "whitebox": (dict(zip(keys, (45, 10, 10, 0, 0, 5))),
                         dict(zip(keys, (9, 2, 2, 0, 0, 1)))),
            "spatial": (dict(zip(keys, (162, 12, 12, 0, 6, 0))),
                        dict(zip(keys, (9, 2, 2, 0, 1, 0))))}
    kernels = smoke.summarize(records, runs)
    assert [k["source"].split("/")[-1] for k in kernels] == [
        "styled_conv.cu", "conv3x3.cu", "pgd_update.cu", "adam_update.cu"]
    by_name = {k["name"]: k for k in kernels}
    for k in kernels:
        for key in ("route", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms"):
            assert key in k, (k["name"], key)
        for path in runs:
            assert f"launches_{path}_path" in k and f"launches_per_{path}_step" in k
    styled = by_name["styled_conv"]
    assert styled["launches"] == 81 + 45 + 162 and styled["launches_spatial_path"] == 162
    assert styled["launches_per_spatial_step"] == 9 and styled["ms"] == 1.0
    assert styled["spatial"]["ms"] == 3.5 and styled["whitebox"]["ms"] == 3.0
    assert by_name["pgd_update"]["spatial"]["ms"] == 0.1
    assert by_name["conv3x3"]["launches"] == 24 + 20 + 24
    assert by_name["conv3x3"]["parts"]["forward"]["launches_per_spatial_step"] == 2
    assert "spatial" not in by_name["conv3x3"]  # the batch-1 shapes are the PGD path's


GOOD_STEP = {"styled_conv": 9.0, "conv3x3_fwd": 2.0, "conv3x3_dgrad": 2.0, "conv3x3_wgrad": 0.0,
             "pgd_update": 1.0, "fused_adam": 0.0}


@pytest.mark.parametrize("change,expect", [
    ({}, None),
    ({"styled_conv": 10.0}, None),  # a floor, not an exact count
    ({"conv3x3_fwd": 0.0}, "conv3x3_fwd 0.0 times"),
    ({"conv3x3_dgrad": 1.0}, "conv3x3_dgrad 1.0 times"),
    ({"pgd_update": 0.0}, "pgd_update 0.0 times"),
    ({"styled_conv": 4.0}, "styled_conv 4.0 times"),
])
def test_spatial_launch_check(smoke, change, expect):
    short = smoke.spatial_launch_failures({**GOOD_STEP, **change}, 27, 18, 3)
    assert short == [] if expect is None else (len(short) == 1 and expect in short[0])


def test_spatial_launch_check_counts_forwards_and_partials(smoke):
    assert smoke.spatial_launch_failures(GOOD_STEP, 27, 18, 3) == []
    short = smoke.spatial_launch_failures(GOOD_STEP, 26, 18, 3)
    assert len(short) == 1 and "fused forwards launched styled_conv 26" in short[0]
    short = smoke.spatial_launch_failures(GOOD_STEP, 27, 9, 3)
    assert len(short) == 1 and "partial fusions launched styled_conv 9" in short[0]

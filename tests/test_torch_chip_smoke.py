"""``chip_smoke.py``'s kernel check fails a kernel whose output is not finite;
its summaries and launch checks, phase 5d's patch-batch check, phase 5f's
checks of the CLI's run folders, launches and landmarks, and phase 5h's
launch expectations of the car and church generators (conv3x3 exactly 0
for church) and its run-folder check of their presets.

The script's error helpers take ``torch`` as an argument and run on CPU
tensors, so they are checked here without a card.
"""

import importlib.util
import math
import os
import types

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
ptxas info    : Compiling entry function '_ZN2tf26conv3x3_wgrad_wgmma_kernelINS_9WgradTileILi64ELi16ELi3EEEEEv14CUtensorMap_stS3_Pfiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2tf20conv3x3_wgrad_kernelIfEEvPKT_S3_Pfiiii' for 'sm_90a'
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 95 registers, used 1 barriers, 42496 bytes smem
ptxas info    : Compiling entry function '_ZN2tf20conv3x3_wgmma_kernelILb1ENS_6WgTileILi16ELi16ELi2ELi1ELi4ELi32ELi32ELi8ELb1ELi1EEEEEv14CUtensorMap_stPK13__nv_bfloat16PS4_PKfS9_S9_S9_iiiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_ptxas_summary_names_the_tile_classes(smoke):
    assert smoke.ptxas_summary(PTXAS) == [
        ("conv3x3_wgrad_wgmma_kernel<WgradTile<64, 16, 3>>", 128, 0),
        ("conv3x3_wgrad_kernel<float>", 95, 20),
        ("conv3x3_wgmma_kernel<styled, WgTile<16, 16, 2, 1, 4, 32, 32, 8, 1, 1>>", 168, 0)]


SASS = """\
        code for sm_90a
                Function : _ZN2tf20conv3x3_wgmma_kernelILb1ENS_6WgTileILi8ELi8ELi1ELi1ELi1ELi32ELi32ELi4ELb0ELi2EEEEEv14CUtensorMap_st
        /*0a10*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0a20*/                   UBLKCP.S.G [UR8], [UR10], UR12 ;
        /*1d40*/                   HGMMA.64x32x16.F32.BF16 R56, R88, gdesc[UR4], R56 ;
                Function : _ZN2tf26conv3x3_wgrad_wgmma_kernelINS_9WgradTileILi64ELi16ELi3EEEEEv14CUtensorMap_stS3_Pfiii
        /*0400*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0410*/                   UTMALDG.4D [UR12], [UR6] ;
        /*1200*/                   HGMMA.64x64x16.F32.BF16 R24, R88, gdesc[UR4], R24 ;
        /*1210*/                   HGMMA.64x64x16.F32.BF16 R56, R92, gdesc[UR4], R56 ;
                Function : _ZN2tf20conv3x3_wgrad_kernelIfEEvPKT_S3_Pfiiii
        /*0200*/                   FFMA R4, R8, R12, R4 ;
"""


def test_sass_gate_reads_the_forward_kernels(smoke):
    """Phase 2's SASS gate counts HGMMA, UTMALDG and HMMA in the bf16 conv
    kernels only (the float32 weight grad is not one), and fails a forward
    kernel without wgmma or TMA, or with mma.sync."""
    counts = smoke.sass_counts(SASS)
    fwd, wgrad = counts
    assert counts[fwd] == {"HGMMA": 1, "UTMALDG": 1, "UBLKCP": 1, "HMMA": 0}
    assert smoke.sass_failures(counts) == []
    assert smoke.sass_failures({fwd: counts[fwd]}, smoke.SASS_KERNELS["styled_conv"]) == []
    for bad in ({"HGMMA": 0, "UTMALDG": 1, "UBLKCP": 1, "HMMA": 0},
                {"HGMMA": 4, "UTMALDG": 0, "UBLKCP": 1, "HMMA": 0},
                {"HGMMA": 4, "UTMALDG": 1, "UBLKCP": 1, "HMMA": 2}):
        assert smoke.sass_failures({**counts, fwd: bad}) == [f"{fwd}: {bad}"]
    assert smoke.sass_failures({}, smoke.SASS_KERNELS["styled_conv"]) == [
        "no conv3x3_wgmma_kernel in the SASS"]


def test_sass_gate_reads_the_weight_grad_kernel(smoke):
    """The gate holds conv3x3's library to a weight-grad kernel on wgmma and
    TMA: real counts pass; one with HMMA, or without UTMALDG or HGMMA,
    fails, and so does a library without it."""
    counts = smoke.sass_counts(SASS)
    fwd, wgrad = counts
    assert "conv3x3_wgrad_wgmma_kernel" in wgrad
    assert counts[wgrad] == {"HGMMA": 2, "UTMALDG": 2, "UBLKCP": 0, "HMMA": 0}
    assert smoke.sass_failures(counts, smoke.SASS_KERNELS["conv3x3"]) == []
    for bad in ({"HGMMA": 2, "UTMALDG": 2, "UBLKCP": 0, "HMMA": 18},
                {"HGMMA": 2, "UTMALDG": 0, "UBLKCP": 0, "HMMA": 0},
                {"HGMMA": 0, "UTMALDG": 2, "UBLKCP": 0, "HMMA": 0}):
        assert smoke.sass_failures({**counts, wgrad: bad}) == [f"{wgrad}: {bad}"]
    assert smoke.sass_failures({fwd: counts[fwd]}) == [
        "no conv3x3_wgrad_wgmma_kernel in the SASS"]
    assert smoke.sass_failures({}) == ["no conv3x3_wgmma_kernel in the SASS",
                                       "no conv3x3_wgrad_wgmma_kernel in the SASS"]


def test_profiler_groups_keep_the_weight_grad_kernels_apart(smoke):
    def group(key):
        return next((g for pat, g in smoke.KERNEL_NAMES if pat in key), "other kernels")

    assert group("void tf::conv3x3_wgrad_wgmma_kernel<tf::WgradTile<32, 16, 5> >("
                 "CUtensorMap_st, CUtensorMap_st, float*, int, int, int)") == "conv3x3_wgrad bf16"
    assert group("void tf::conv3x3_wgrad_kernel<float>(float const*, ...)") == \
        "conv3x3_wgrad fp32"
    assert group("tf::sum_partials_kernel(float const*, float*, int, int)") == \
        "conv3x3_wgrad second pass"
    assert group("void tf::conv3x3_wgmma_kernel<false, tf::WgTile<16, 16, 2, 1, 4, 32, 32, "
                 "8, true, 1> >(...)") == "conv3x3_fwd/dgrad bf16"
    assert group("void tf::conv3x3_wgmma_kernel<true, tf::WgTile<8, 8, 1, 1, 1, 32, 32, 4, "
                 "false, 2> >(...)") == "styled_conv bf16"
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


PATCH_COUNTS = {"styled_conv": 342, "conv3x3_fwd": 34, "conv3x3_dgrad": 34, "conv3x3_wgrad": 0,
                "pgd_update": 0, "fused_adam": 17}


@pytest.mark.parametrize("change,expect", [
    ({}, None),
    ({"pgd_update": 3}, None),  # off the path, not required
    ({"styled_conv": 0}, "styled_conv no time"),
    ({"conv3x3_fwd": 0}, "conv3x3_fwd no time"),
    ({"conv3x3_dgrad": 0}, "conv3x3_dgrad no time"),
    ({"fused_adam": 0}, "fused_adam no time"),
    ({"conv3x3_wgrad": 1}, "weight grad 1 times"),
])
def test_patch_launch_check(smoke, change, expect):
    short = smoke.patch_launch_failures({**PATCH_COUNTS, **change})
    assert short == [] if expect is None else (len(short) == 1 and expect in short[0])


def test_summarize_carries_the_patch_run(smoke):
    """The phase-5d path's launches enter every kernel's entry, and
    fused_adam timed at the legacy optimize's shape carries it under
    ``patch``."""
    records = [_record("fused_adam", "whitebox", 0.15, dtype="float32", lib=0.17),
               _record("fused_adam", "patch", 0.04, dtype="float32", lib=0.05)]
    keys = tuple(PATCH_COUNTS)
    runs = {"whitebox": (dict(zip(keys, (45, 10, 10, 0, 0, 5))),
                         dict(zip(keys, (9, 2, 2, 0, 0, 1)))),
            "patch": (PATCH_COUNTS, dict.fromkeys(keys, 0.0))}
    adam = smoke.summarize(records, runs)[-1]
    assert adam["name"] == "fused_adam" and adam["launches"] == 5 + 17
    assert adam["launches_patch_path"] == 17 and adam["launches_per_patch_step"] == 0
    assert adam["ms"] == 0.15 and adam["patch"]["ms"] == 0.04


@pytest.mark.parametrize("trace,patch,descent,expect", [
    ([-1.0, -1.1, -1.2], 0.5, True, None),
    ([-1.0, -0.9, -1.2], 0.5, True, None),  # first to last
    ([-1.0, -1.1, -0.9], 0.5, True, "did not fall"),
    ([-1.0, -1.1, -0.9], 0.5, False, None),  # the bf16 run: range only
    ([-1.0, float("nan"), -1.2], 0.5, False, "did not fall"),
    ([-1.0, -1.1, -1.2], 1.5, True, "leaves the image's range"),
])
def test_patch_batch_check(smoke, monkeypatch, trace, patch, descent, expect):
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    img = torch.linspace(-1, 1, 12).reshape(1, 2, 2, 3)
    smoke._check_patch_batch(torch, "batch", img, torch.full((2, 2, 3), patch),
                             torch.tensor(trace), descent)
    assert failures == [] if expect is None else (len(failures) == 1 and expect in failures[0])


CLASSIFIER_PGD = {"styled_conv": 0, "conv3x3_fwd": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0,
                  "pgd_update": 100, "fused_adam": 0}
CLASSIFIER_CW = {**CLASSIFIER_PGD, "pgd_update": 0, "fused_adam": 200}
CLASSIFIER_FUSE = {**CLASSIFIER_PGD, "pgd_update": 0, "styled_conv": 108}


@pytest.mark.parametrize("run,change,expect", [
    (None, {}, None),
    ("pgd", {"pgd_update": 99}, "resnet PGD (100 steps) launched pgd_update 99"),
    ("pgd", {"fused_adam": 1}, "resnet PGD (100 steps) launched pgd_update 100 and fused_adam 1"),
    ("vit", {"pgd_update": 0}, "ViT PGD (100 steps) launched pgd_update 0"),
    ("cw", {"fused_adam": 199}, "CW (200 steps) launched fused_adam 199"),
    ("cw", {"pgd_update": 2}, "and pgd_update 2 times"),
    ("fuse", {"styled_conv": 0}, "styled_conv no time"),
    ("fuse", {"conv3x3_wgrad": 3}, "the transfer fusions launched the weight grad 3"),
])
def test_classifier_launch_check(smoke, run, change, expect):
    runs = {"pgd": CLASSIFIER_PGD, "cw": CLASSIFIER_CW, "vit": CLASSIFIER_PGD,
            "fuse": CLASSIFIER_FUSE}
    if run:
        runs[run] = {**runs[run], **change}
    short = smoke.classifier_launch_failures(runs["pgd"], runs["cw"], runs["vit"], runs["fuse"])
    assert short == [] if expect is None else (len(short) == 1 and expect in short[0])


def test_cw_bookkeeping_check(smoke):
    images = torch.linspace(-0.5, 0.5, 2 * 4 * 4 * 3).reshape(2, 4, 4, 3)
    adv = images.clone()
    adv[1] += 0.1
    l2 = torch.tensor([math.inf, ((adv[1] - images[1]) ** 2).sum().item()])
    assert smoke.cw_bookkeeping_failures(torch, images, adv, l2, "cw") == []
    moved = adv.clone()
    moved[0, 0, 0, 0] += 1e-7  # an image without success must stay bit for bit
    assert "has moved" in smoke.cw_bookkeeping_failures(torch, images, moved, l2, "cw")[0]
    off = smoke.cw_bookkeeping_failures(torch, images, adv, l2 * (1 + 1e-4), "cw")
    assert len(off) == 1 and "not the L2" in off[0]
    out = smoke.cw_bookkeeping_failures(torch, images, adv * 4, torch.full((2,), math.inf), "cw")
    assert any("leaves [-1, 1]" in f for f in out)


def test_cw_margins_are_the_attacks(smoke):
    from tpufusion_torch.attacks.cw import CWConfig, make_cw

    logits = torch.tensor([[2.0, 0.5, 1.0], [0.0, 3.0, -1.0]])
    labels = torch.tensor([0, 2], dtype=torch.int32)
    assert smoke._cw_margins(torch, logits, labels).tolist() == [1.0, -4.0]
    # an image whose clean margin is already met is its own best iterate
    x = torch.zeros(2, 1, 1, 3)
    adv, l2 = make_cw(lambda im: logits, CWConfig(steps=1))(x, labels)
    assert torch.isinf(l2[0]) and l2[1].item() < 1e-9 and torch.equal(adv, x)


def test_summarize_carries_the_classifier_run(smoke):
    """The phase-5e path's launches enter every entry; pgd_update and
    fused_adam timed at its 8 x 1024^2 x 3 shape carry it under
    ``classifier``."""
    records = [_record("pgd_update", "pgd", 0.04, dtype="float32"),
               _record("pgd_update", "classifier", 0.15, dtype="float32"),
               _record("fused_adam", "whitebox", 0.15, dtype="float32", lib=0.17),
               _record("fused_adam", "classifier", 0.25, dtype="float32", lib=0.28)]
    keys = tuple(CLASSIFIER_PGD)
    total = {k: CLASSIFIER_PGD[k] + CLASSIFIER_CW[k] + CLASSIFIER_PGD[k] + CLASSIFIER_FUSE[k]
             for k in keys}
    per_step = {**{k: CLASSIFIER_PGD[k] / 100 for k in keys}, "fused_adam": 1.0}
    runs = {"pgd": (dict(zip(keys, (81, 12, 12, 0, 6, 0))), dict(zip(keys, (9, 2, 2, 0, 1, 0)))),
            "whitebox": (dict(zip(keys, (45, 10, 10, 0, 0, 5))),
                         dict(zip(keys, (9, 2, 2, 0, 0, 1)))),
            "classifier": (total, per_step)}
    by_name = {k["name"]: k for k in smoke.summarize(records, runs)}
    pgd, adam = by_name["pgd_update"], by_name["fused_adam"]
    assert pgd["launches_classifier_path"] == 200 and pgd["launches"] == 206
    assert pgd["launches_per_classifier_step"] == 1 and pgd["classifier"]["ms"] == 0.15
    assert adam["launches_classifier_path"] == 200 and adam["launches_per_classifier_step"] == 1
    assert adam["classifier"]["library_ms"] == 0.28 and adam["ms"] == 0.15
    assert by_name["styled_conv"]["launches_classifier_path"] == 108


# ---------------------------------------------------------------------------
# phase 5f: the attack_run CLI's run folders, launches and landmarks
# ---------------------------------------------------------------------------

CLI_COUNTS = {"styled_conv": 162, "conv3x3_fwd": 8, "conv3x3_dgrad": 8, "conv3x3_wgrad": 0,
              "pgd_update": 2, "fused_adam": 2}


@pytest.mark.parametrize("kernel", [None, "styled_conv", "conv3x3_fwd", "conv3x3_dgrad",
                                    "pgd_update", "fused_adam"])
def test_cli_launch_check(smoke, kernel):
    counts = dict(CLI_COUNTS)
    if kernel:
        counts[kernel] = 0
    assert smoke.cli_launch_failures(counts) == (
        [f"phase 5f launched {kernel} no time"] if kernel else [])


def test_summarize_carries_the_cli_run(smoke):
    """The CLI's whole-run counts enter every entry under ``cli``, with no
    per-step count (the run has no one step)."""
    records = [_record("pgd_update", "pgd", 0.04, dtype="float32")]
    keys = tuple(CLI_COUNTS)
    runs = {"pgd": (dict(zip(keys, (81, 12, 12, 0, 6, 0))), dict(zip(keys, (9, 2, 2, 0, 1, 0)))),
            "cli": (CLI_COUNTS, None)}
    by_name = {k["name"]: k for k in smoke.summarize(records, runs)}
    assert by_name["pgd_update"]["launches_cli_path"] == 2
    assert by_name["pgd_update"]["launches"] == 8
    assert "launches_per_cli_step" not in by_name["pgd_update"]
    assert by_name["fused_adam"]["launches_cli_path"] == 2
    assert by_name["conv3x3"]["parts"]["weight_grad"]["launches_cli_path"] == 0


def _write_run(root, attack, n=2, size=4, *, eps_move=0.0, rows=1, cols=None, nan=False,
               skip=(), dataset="ffhq"):
    """A run folder as the runner writes it, with one fault to inject."""
    import json

    import numpy as np

    from tpufusion_torch.io.xlsx import write_xlsx

    run = os.path.join(root, f"0_{dataset}_{attack}")
    os.makedirs(os.path.join(run, "adversarial"))
    if "parameters.txt" not in skip:
        open(os.path.join(run, "parameters.txt"), "w").write("adversarial attack x\n")
    lists = {k: [0.5] * (n + 1) for k in ("cri_spatial", "cri_arith", "vg_spatial",
                                          "vg_arith", "ssim_spatial", "ssim_arith")}
    if nan:
        lists["vg_arith"][1] = float("nan")
    with open(os.path.join(run, "results.jsonl"), "w") as f:
        for b in range(rows):
            f.write(json.dumps(dict(attack=attack, batch=b, noise_mse=0.1, **lists)) + "\n")
    ncols = n + 6 * (n + 1) if cols is None else cols
    write_xlsx(os.path.join(run, "new_mask.xlsx"), ["c"] * ncols, [[0.0] * ncols] * rows)
    x = np.zeros((n, size, size, 3), np.float32)
    np.savez(os.path.join(run, "adversarial", "all_inputs.npz"), data=x)
    if "all_adv_inputs" not in skip:
        np.savez(os.path.join(run, "adversarial", "all_adv_inputs.npz"), data=x + eps_move)
    return run


def test_cli_run_check_passes_a_good_run(smoke, tmp_path):
    for attack in ("fusion_pgd_arith", "white_box_target", "blur"):
        _write_run(str(tmp_path), attack, eps_move=0.05)
    assert smoke.cli_run_failures(str(tmp_path), ("fusion_pgd_arith", "white_box_target",
                                                  "blur"), 2, 4) == []


@pytest.mark.parametrize("fault,expect", [
    (dict(eps_move=0.2), "leaves the eps-ball"),
    (dict(eps_move=-1.5), "leaves [-1, 1]"),
    (dict(nan=True), "non-finite"),
    (dict(cols=3), "new_mask.xlsx has 3 columns"),
    (dict(skip=("parameters.txt",)), "no parameters.txt"),
    (dict(skip=("all_adv_inputs",)), "all_adv_inputs.npz unreadable"),
    (dict(size=8), "has shape (2, 8, 8, 3)"),
    (dict(rows=0), "holds no row"),
])
def test_cli_run_check_fails_a_faulty_run(smoke, tmp_path, fault, expect):
    _write_run(str(tmp_path), "fusion_pgd_arith", **fault)
    bad = smoke.cli_run_failures(str(tmp_path), ("fusion_pgd_arith",), 2, 4)
    assert any(expect in b for b in bad), bad


def test_cli_run_check_wants_one_folder_per_attack(smoke, tmp_path):
    _write_run(str(tmp_path), "blur")
    bad = smoke.cli_run_failures(str(tmp_path), ("blur", "white_box_target"), 2, 4)
    assert bad == [f"white_box_target: 0 run folders under {tmp_path}, expected 1"]
    assert smoke.cli_run_failures(str(tmp_path / "none"), ("blur",), 2, 4) == [
        f"blur: 0 run folders under {tmp_path / 'none'}, expected 1"]


def test_landmark_check(smoke):
    import numpy as np

    from tpufusion_torch.models.landmarks import _canonical_template

    cpu = [_canonical_template() * 1024]
    lm, quad, bad = smoke.landmark_failures([cpu[0] + 0.25], cpu)
    assert lm == pytest.approx(0.25) and quad == pytest.approx(0.25) and bad == []
    moved = cpu[0].copy()
    moved[36:42, 0] += 3.0  # one eye ring 3 px off: the quad moves too
    lm, quad, bad = smoke.landmark_failures([moved], cpu)
    assert lm == pytest.approx(3.0) and quad > 1.0 and len(bad) == 2
    assert "landmarks" in bad[0] and "quad corners" in bad[1]
    _, _, bad = smoke.landmark_failures([cpu[0] + np.float32(np.nan)], cpu)
    assert len(bad) == 2


# phase 5g: the scale-out routes

SHARDED_COUNTS = {"styled_conv": 216, "conv3x3_fwd": 20, "conv3x3_dgrad": 20,
                  "conv3x3_wgrad": 0, "pgd_update": 10, "fused_adam": 7}
PHASE_5G_COUNTS = {
    "sharded": SHARDED_COUNTS,
    "resume": {"styled_conv": 18, "conv3x3_fwd": 4, "conv3x3_dgrad": 4, "conv3x3_wgrad": 0,
               "pgd_update": 0, "fused_adam": 2},
    "export": {"styled_conv": 36, "conv3x3_fwd": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0,
               "pgd_update": 0, "fused_adam": 0},
}


@pytest.mark.parametrize("run,kernel", [
    (None, None), *[(r, k) for r, ks in (
        ("sharded", ("styled_conv", "conv3x3_fwd", "conv3x3_dgrad", "pgd_update", "fused_adam")),
        ("resume", ("styled_conv", "conv3x3_fwd", "conv3x3_dgrad", "fused_adam")),
        ("export", ("styled_conv",))) for k in ks]])
def test_sharded_launch_check(smoke, run, kernel):
    """Each of phase 5g's three counted runs is gated on its own counts: a
    kernel that run skipped fails it, whatever the other runs launched."""
    counts = {r: dict(c) for r, c in PHASE_5G_COUNTS.items()}
    if run:
        counts[run][kernel] = 0
    assert smoke.sharded_launch_failures(counts) == (
        [f"phase 5g's {run} run launched {kernel} no time"] if run else [])


def test_sharded_launch_check_needs_every_run(smoke):
    counts = {r: c for r, c in PHASE_5G_COUNTS.items() if r != "export"}
    assert smoke.sharded_launch_failures(counts) == [
        "phase 5g's export run launched styled_conv no time"]


def test_held_check(smoke):
    want = torch.tensor([1.0, 2.0, math.inf])
    assert smoke.held_failures(torch, "r", want.clone(), want) == (0.0, [])
    err, bad = smoke.held_failures(torch, "r", torch.tensor([1.0, 2.002, math.inf]), want,
                                   rtol=1e-3)
    assert err == pytest.approx(0.002, rel=1e-3) and "from the single-device route" in bad[0]
    assert smoke.held_failures(torch, "r", torch.tensor([1.0, 2.002, math.inf]), want,
                               rtol=2e-3)[1] == []
    # finite where the single-device route is not (CW's inf for no success), or back
    for got in (torch.tensor([1.0, 2.0, 3.0]), torch.tensor([math.nan, 2.0, math.inf])):
        assert "finite where" in smoke.held_failures(torch, "r", got, want)[1][0]
    assert "shape" in smoke.held_failures(torch, "r", want[:2], want)[1][0]


@pytest.mark.parametrize("fault", [None, "ulp", "nan", "shape"])
def test_held_check_is_bit_equal_by_default(smoke, fault):
    """With no tolerance given a route is held bit for bit: one float32 ulp
    off one pixel fails it."""
    want = torch.linspace(-1, 1, 2 * 8 * 8 * 3).reshape(2, 8, 8, 3)
    got = want.clone()
    if fault == "ulp":
        got[1, 3, 4, 2] = torch.nextafter(got[1, 3, 4, 2], torch.tensor(2.0))
    elif fault == "nan":
        got[0, 0, 0, 0] = math.nan
    elif fault == "shape":
        got = got[:1]
    err, bad = smoke.held_failures(torch, "sharded pgd", got, want)
    if fault is None:
        assert (err, bad) == (0.0, [])
    else:
        assert len(bad) == 1 and err > 0, (err, bad)


def test_summarize_carries_the_sharded_run(smoke):
    records = [_record("pgd_update", "pgd", 0.04, dtype="float32")]
    keys = tuple(SHARDED_COUNTS)
    runs = {"pgd": (dict(zip(keys, (81, 12, 12, 0, 6, 0))), dict(zip(keys, (9, 2, 2, 0, 1, 0)))),
            "cli": (CLI_COUNTS, None), **{r: (c, None) for r, c in PHASE_5G_COUNTS.items()}}
    by_name = {k["name"]: k for k in smoke.summarize(records, runs)}
    styled = by_name["styled_conv"]
    assert (styled["launches_sharded_path"], styled["launches_resume_path"],
            styled["launches_export_path"]) == (216, 18, 36)
    assert styled["launches"] == 81 + CLI_COUNTS["styled_conv"] + 216 + 18 + 36
    assert by_name["pgd_update"]["launches"] == 6 + 2 + 10
    assert by_name["fused_adam"]["launches_sharded_path"] == 7
    assert by_name["fused_adam"]["launches_resume_path"] == 2
    assert "launches_per_sharded_step" not in by_name["fused_adam"]
    assert by_name["conv3x3"]["parts"]["input_grad"]["launches_sharded_path"] == 20
    assert by_name["conv3x3"]["parts"]["input_grad"]["launches_resume_path"] == 4
    assert by_name["conv3x3"]["parts"]["weight_grad"]["launches_sharded_path"] == 0


# ---------------------------------------------------------------------------
# phase 5h: car 512^2 and church 256^2
# ---------------------------------------------------------------------------

def _plan(size):
    """The config-f generator's ``conv_plan()`` at ``size``, without
    building its weights (the plan reads only the size and the multiplier)."""
    import types

    from tpufusion_torch.models.stylegan2 import Generator

    return Generator.conv_plan(types.SimpleNamespace(size=size, channel_multiplier=2))


@pytest.mark.parametrize("size,expect", [(512, (8, 1)), (256, (7, 0)), (1024, (9, 2))])
def test_family_expectations_come_from_the_plan(smoke, size, expect):
    """styled_conv launches per synthesis forward and the convs whose
    backward runs through conv3x3: car 8 and 1 (64 channels at 512^2),
    church 7 and none (no 32/64-channel layer), FFHQ 9 and 2."""
    assert smoke.family_expectations(_plan(size)) == expect


def _family_runs(fam):
    keys = ("styled_conv", "conv3x3_fwd", "conv3x3_dgrad", "conv3x3_wgrad", "pgd_update",
            "fused_adam")
    per_fwd, n_c3 = {"car": (8, 1), "church": (7, 0)}[fam]
    steps = 3

    def c(styled=0, c3=0, pgd=0, adam=0):
        return dict(zip(keys, (styled, c3, c3, 0, pgd, adam)))

    runs = {"forwards": c(per_fwd * 3), "eval": c(2 * per_fwd),
            "pgd_step": c(2 * per_fwd, 2 * n_c3, 1), "spatial_step": c(2 * per_fwd, n_c3, 1),
            "whitebox": c(2 * per_fwd * steps, 2 * n_c3 * steps, 0, steps),
            "classifier_pgd": c(0, 0, steps), "cli": c(100, 4 * n_c3, 2, 2)}
    if fam == "car":
        runs["cw"] = c(0, 0, 0, steps)
    runs["all"] = c(400, 20 * n_c3, 20, 10)
    return runs


@pytest.mark.parametrize("fam", ["car", "church"])
def test_family_launch_check_passes_a_good_run(smoke, fam):
    assert smoke.FAMILY_STEPS == 3 and smoke.FAMILY_FWD == 3
    size = smoke.FAMILY_STYLED[fam][1]
    assert smoke.family_launch_failures(fam, _plan(size), _family_runs(fam)) == []


@pytest.mark.parametrize("run,kernel,value,expect", [
    ("all", "conv3x3_fwd", 1, "church all: conv3x3_fwd launched 1 times, expected 0"),
    ("all", "conv3x3_dgrad", 2, "church all: conv3x3_dgrad launched 2 times, expected 0"),
    ("all", "conv3x3_wgrad", 1, "church all: conv3x3_wgrad launched 1 times"),
    ("forwards", "styled_conv", 27, "church forwards: styled_conv launched 27 times, "
                                    "expected 21"),
    ("eval", "styled_conv", 18, "church eval: styled_conv launched 18 times, expected 14"),
    ("pgd_step", "pgd_update", 2, "church pgd_step: pgd_update launched 2 times, expected 1"),
    ("whitebox", "fused_adam", 2, "church whitebox: fused_adam launched 2 times, expected 3"),
    ("classifier_pgd", "fused_adam", 1, "church classifier_pgd: fused_adam launched 1 times"),
])
def test_church_launch_check(smoke, run, kernel, value, expect):
    """Church's generator has no 32/64-channel conv: a conv3x3 launch
    anywhere in its phase is a failure, as is any count off the plan's."""
    runs = _family_runs("church")
    runs[run] = {**runs[run], kernel: value}
    assert expect in "; ".join(smoke.family_launch_failures("church", _plan(256), runs))


@pytest.mark.parametrize("run,kernel,value,expect", [
    ("pgd_step", "conv3x3_fwd", 0, "car pgd_step: conv3x3_fwd launched 0 times, expected >= 1"),
    ("spatial_step", "conv3x3_dgrad", 0, "car spatial_step: conv3x3_dgrad launched 0 times"),
    ("cli", "conv3x3_fwd", 0, "car cli: conv3x3_fwd launched 0 times, expected > 0"),
    ("cw", "fused_adam", 2, "car cw: fused_adam launched 2 times, expected 3"),
    ("pgd_step", "styled_conv", 7, "car pgd_step: styled_conv launched 7 times, expected >= 8"),
])
def test_car_launch_check(smoke, run, kernel, value, expect):
    runs = _family_runs("car")
    runs[run] = {**runs[run], kernel: value}
    assert expect in "; ".join(smoke.family_launch_failures("car", _plan(512), runs))


def test_summarize_carries_the_family_runs(smoke):
    """Phase 5h's records under their paths: the kernels timed at the car
    and church shapes carry them under "car" and "church", and each entry
    has both runs' launches; church's conv3x3 launches are 0."""
    records = [_record("styled_conv", "pgd", 1.0), _record("styled_conv", "car", 2.0),
               _record("styled_conv", "church", 0.7),
               _record("conv3x3_fwd", "pgd", 0.2, lib=0.25),
               _record("conv3x3_fwd", "car", 0.3, lib=0.35),
               _record("conv3x3_dgrad", "car", 0.3, lib=1.5),
               _record("pgd_update", "pgd", 0.04, dtype="float32"),
               _record("pgd_update", "car", 0.02, dtype="float32"),
               _record("pgd_update", "church", 0.01, dtype="float32"),
               _record("fused_adam", "whitebox", 0.15, dtype="float32", lib=0.17),
               _record("fused_adam", "car", 0.04, dtype="float32", lib=0.05),
               _record("fused_adam", "church", 0.01, dtype="float32", lib=0.02)]
    car, church = _family_runs("car"), _family_runs("church")
    keys = tuple(car["all"])
    runs = {"pgd": (dict(zip(keys, (81, 12, 12, 0, 6, 0))), dict(zip(keys, (9, 2, 2, 0, 1, 0)))),
            "whitebox": (dict(zip(keys, (45, 10, 10, 0, 0, 5))),
                         dict(zip(keys, (9, 2, 2, 0, 0, 1)))),
            "car": (car["all"], car["pgd_step"]), "church": (church["all"], church["pgd_step"])}
    by_name = {k["name"]: k for k in smoke.summarize(records, runs)}
    styled = by_name["styled_conv"]
    assert styled["car"]["ms"] == 2.0 and styled["church"]["ms"] == 0.7
    assert styled["launches_car_path"] == styled["launches_church_path"] == 400
    assert styled["launches_per_car_step"] == 16 and styled["launches_per_church_step"] == 14
    assert styled["launches"] == 81 + 45 + 400 + 400
    conv = by_name["conv3x3"]
    assert conv["car"]["ms"] == pytest.approx(0.6) and conv["car"]["library_ms"] == \
        pytest.approx(1.85)
    assert "church" not in conv and conv["launches_church_path"] == 0
    assert conv["launches_car_path"] == 40 and conv["launches_per_car_step"] == 4
    assert by_name["pgd_update"]["car"]["ms"] == 0.02
    assert by_name["pgd_update"]["church"]["ms"] == 0.01
    adam = by_name["fused_adam"]
    assert adam["ms"] == 0.15 and adam["car"]["ms"] == 0.04 and adam["church"]["ms"] == 0.01
    assert adam["launches_car_path"] == adam["launches_church_path"] == 10
    for k in by_name.values():
        for key in ("route", "replaces", "launches", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            assert key in k, (k["name"], key)


@pytest.mark.parametrize("fam", ["car", "church"])
def test_cli_run_check_reads_the_family_folders(smoke, tmp_path, fam):
    """Phase 5h's attack_run writes ``<k>_<family>_<attack>`` folders; the
    check finds them by the family's name, and an FFHQ folder is not one."""
    attacks = ("white_box_target", "fusion_pgd_spatial", "blur")
    for attack in attacks:
        _write_run(str(tmp_path), attack, n=3, eps_move=0.05, dataset=fam)
    assert smoke.cli_run_failures(str(tmp_path), attacks, 3, 4, pgd_attacks=(
        "fusion_pgd_spatial",), dataset=fam) == []
    assert smoke.cli_run_failures(str(tmp_path), attacks, 3, 4)[0] == \
        f"white_box_target: 0 run folders under {tmp_path}, expected 1"


def test_montage_size_of_fuse(smoke):
    assert smoke._montage_size(32) == (6 * 34 + 2, 36)
    assert smoke._montage_size(512) == (6 * 514 + 2, 516)


STREAM_PTXAS = """\
ptxas info    : Compiling entry function '_ZN9tf_stream17stream_reg_kernelIfLi3ELi1EN12_GLOBAL__N_15PgdOpIfEELi2EEEvNS_7StreamsIT_XT0_EXT1_EEExNS_5SplitET2_' for 'sm_90a'
ptxas info    : Used 40 registers, used 0 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9tf_stream17stream_reg_kernelI13__nv_bfloat16Li3ELi1EN12_GLOBAL__N_15PgdOpIS1_EELi1EEEvNS_7StreamsIT_XT0_EXT1_EEExNS_5SplitET2_' for 'sm_90a'
ptxas info    : Used 30 registers, used 0 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9tf_stream17stream_reg_kernelIfLi4ELi3EN12_GLOBAL__N_16AdamOpELi1EEEvNS_7StreamsIT_XT0_EXT1_EEExNS_5SplitET2_' for 'sm_90a'
ptxas info    : Used 37 registers, used 0 barriers, 440 bytes cmem[0]
"""  # noqa: E501


def test_ptxas_summary_names_the_stream_kernels(smoke):
    """The pixel updates' kernels (namespace tf_stream) are read with their
    element type and, for the register kernel, its vectors a thread."""
    assert smoke.ptxas_summary(STREAM_PTXAS) == [
        ("stream_reg_kernel<float, U=2>", 40, 0),
        ("stream_reg_kernel<bf16, U=1>", 30, 0),
        ("stream_reg_kernel<float, U=1>", 37, 0)]


def test_profiler_groups_name_the_pixel_updates(smoke):
    def group(key):
        return next((g for pat, g in smoke.KERNEL_NAMES if pat in key), "other kernels")

    assert group("void tf_stream::stream_reg_kernel<float, 3, 1, (anonymous namespace)::"
                 "PgdOp<float>, 2>(...)") == "pgd_update"
    assert group("void tf_stream::stream_reg_kernel<float, 4, 3, (anonymous namespace)::"
                 "AdamOp, 1>(...)") == "fused_adam"


@pytest.mark.parametrize("freed_gib, waits", [(13.0, True), (0.25, False)])
def test_release_cache_waits_out_a_large_release(smoke, monkeypatch, freed_gib, waits):
    """Before a graph timing the allocator's cache is given back, and a
    release of more than ``SETTLE_BYTES`` is waited out for ``SETTLE_S``."""
    reserved = [14 << 30]
    calls, slept = [], []

    def empty_cache():
        calls.append("empty_cache")
        reserved[0] -= int(freed_gib * (1 << 30))
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: calls.append("synchronize"),
        memory_reserved=lambda: reserved[0], empty_cache=empty_cache))
    monkeypatch.setattr(smoke.time, "sleep", slept.append)
    smoke.release_cache(fake)
    assert calls == ["synchronize", "empty_cache"]
    assert slept == ([smoke.SETTLE_S] if waits else [])


@pytest.mark.parametrize("shape, copies", [((3, 256, 256, 3), 20), ((2, 1024, 1024, 3), 4),
                                           ((8, 1024, 1024, 3), 2)])
def test_cold_ms_cycles_over_copies_far_apart(smoke, monkeypatch, shape, copies):
    """``cold_ms`` captures its launches over enough copies of the buffers
    that more than ``COLD_BYTES`` of the others pass between two uses of
    one (at most one copy a launch), and times them through ``graph_ms``."""
    seen = []
    monkeypatch.setattr(smoke, "graph_ms", lambda torch_, fn, **k: [
        fn() for _ in range(smoke.GRAPH_LAUNCHES + 1)] and [1.0, 2.0])
    planes = [torch.empty(shape, device="meta") for _ in range(3)]
    monkeypatch.setattr(torch.Tensor, "clone", lambda t: torch.empty(t.shape, device="meta"))
    assert smoke.cold_ms(torch, lambda *t: seen.append(tuple(map(id, t))), planes) == [1.0, 2.0]
    assert len(set(seen)) == copies
    plane = 4 * math.prod(shape) * 3
    assert (copies - 1) * plane >= smoke.COLD_BYTES or copies == smoke.GRAPH_LAUNCHES


def test_numbers_carry_the_host_and_floor_readings(smoke):
    """A kernel's entry sums the host us, the warm and time_ms readings over
    the home path's timed shapes and carries the launch floor."""
    extra = dict(host_us=10.0, event_ms=0.05, warm_ms=0.03, floor_ms=0.001, floor_host_us=4.0)
    records = [dict(_record("pgd_update", "pgd", 0.04, dtype="float32"), **extra),
               dict(_record("pgd_update", "pgd", 0.02, dtype="float32"), **extra)]
    out = smoke._numbers(records, "pgd")
    assert out["ms"] == pytest.approx(0.06) and out["host_us"] == pytest.approx(20.0)
    assert out["event_ms"] == pytest.approx(0.1) and out["warm_ms"] == pytest.approx(0.06)
    assert out["floor_ms"] == 0.001 and out["floor_host_us"] == 4.0
    assert "graph_ms" not in out


# the attack loops' gates: a graph replay against its eager twin


def test_graph_failures_hold_results_bit_for_bit(smoke):
    import numpy as np

    got = (torch.ones(2, 3), {"total": torch.arange(4.0), "l2": torch.tensor([1.0, math.inf])},
           dict(adv_input=np.zeros((1, 2), np.float32)))
    want = (torch.ones(2, 3), {"total": torch.arange(4.0), "l2": torch.tensor([1.0, math.inf])},
            dict(adv_input=np.zeros((1, 2), np.float32)))
    assert smoke.graph_failures(torch, "pgd", got, want) == (0.0, [])
    off = (got[0] + 1e-7, got[1], got[2])
    err, fails = smoke.graph_failures(torch, "pgd", off, want)
    assert err > 0 and len(fails) == 1 and "eager twin" in fails[0]
    err, fails = smoke.graph_failures(torch, "cw", off, want, atol=1e-6)
    assert fails == [] and err <= 1e-6
    # a trace entry missing, an inf where the twin is finite
    assert smoke.graph_failures(torch, "pgd", got[:2], want)[1]
    bad = (got[0], {"total": got[1]["total"], "l2": torch.tensor([math.inf, math.inf])}, got[2])
    assert smoke.graph_failures(torch, "cw", bad, want, atol=1e-6)[1]


def test_replay_launches_must_equal_an_eager_step(smoke):
    eager = {"styled_conv": 9.0, "conv3x3_fwd": 2.0, "pgd_update": 1.0, "fused_adam": 0.0}
    same = {"styled_conv": 9, "conv3x3_fwd": 2, "pgd_update": 1, "fused_adam": 0}
    assert smoke.replay_launch_failures("pgd", same, eager) == []
    short = smoke.replay_launch_failures("pgd", dict(same, pgd_update=0), eager)
    assert len(short) == 1 and "pgd_update 0" in short[0]
    # a replay that counted the capture's launches twice
    assert smoke.replay_launch_failures("pgd", {k: 2 * v for k, v in same.items()}, eager)


def test_rewound_replays_start_their_counters_at_zero(smoke):
    from tpufusion_torch.core.graphs import StepProgram

    def body(state, inputs):
        state["trace"].index_copy_(0, state["idx"].view(1), state["x"].sum().view(1))
        state["x"].add_(inputs["d"])
        state["idx"].add_(1)

    prog = StepProgram(body, dict(x=torch.zeros(2), trace=torch.zeros(2),
                                  idx=torch.zeros((), dtype=torch.int64)),
                       dict(d=torch.ones(2)), limit=2)
    step = smoke.replay_step(prog)
    for _ in range(5):  # past the limit: rewound each time it is reached
        step()
    assert prog.replays == 5 and int(prog.state["idx"]) == 1
    smoke.rewind(prog)
    assert prog.taken == 0 and int(prog.state["idx"]) == 0
    # the floats are the end state's, the step counters 0
    assert prog.state["x"].tolist() == [5.0, 5.0]


def test_deterministic_restores_the_flags(smoke):
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark, torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    with smoke.deterministic(torch):
        assert cudnn.deterministic and not cudnn.benchmark
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert (cudnn.deterministic, cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled()) == flags
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == env


# the launch audit: what a replay launches, measured by the profiler

STYLED_ROW = "void tf::conv3x3_wgmma_kernel<true, tf::WgTile<16, 16, 2, 1, 4, 32, 32, 8, 1, 1>>"
CONV_ROW = "void tf::conv3x3_wgmma_kernel<false, tf::WgTile<8, 16, 2, 2, 1, 64, 32, 3, 0, 1>>"
PGD_ROW = "void tf_stream::stream_reg_kernel<float, 3, 1, (anonymous namespace)::PgdOp<float>, 1>"


def test_kernel_counts_read_each_wrappers_kernel(smoke):
    rows = [(STYLED_ROW, 1.0, 9), (CONV_ROW, 0.5, 4), (PGD_ROW, 0.1, 1),
            ("void at::native::elementwise_kernel<128, 4>", 2.0, 404),
            ("void tf::sum_partials_kernel", 0.01, 1)]
    got = smoke.kernel_counts(rows)
    assert got == {"styled_conv": 9, "conv3x3_fwd+dgrad": 4, "conv3x3_wgrad": 0,
                   "pgd_update": 1, "fused_adam": 0}
    booked = smoke.audited_counts({"styled_conv": 9, "conv3x3_fwd": 2, "conv3x3_dgrad": 2,
                                   "conv3x3_wgrad": 0, "pgd_update": 1, "fused_adam": 0})
    assert smoke.replay_count_failures("pgd", got, booked) == []
    short = smoke.replay_count_failures("pgd", dict(got, pgd_update=0), booked)
    assert len(short) == 1 and "pgd_update 0" in short[0]


@pytest.fixture
def audited(smoke, monkeypatch):
    """The audit installed over ``StepProgram.run`` with the card stubbed:
    programs on CPU tensors read as the card's, a capture runs the body once
    (its wrappers count, as at a capture), a replay runs nothing, and the
    profiled replay gives ``rows[0]``."""
    import contextlib

    from tpufusion_torch.core import graphs

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: types.SimpleNamespace(
        replay=lambda: None, reset=lambda: None, pool=lambda: None))
    audit = smoke.LaunchAudit(torch).install()
    rows = [[(STYLED_ROW, 1.0, 9), (PGD_ROW, 0.1, 1)]]
    monkeypatch.setattr(audit, "_profile_replay",
                        lambda prog: (audit.orig(prog, 1), rows[0])[1])
    monkeypatch.setattr(smoke, "AUDIT", audit)

    def program(limit=8):
        from tpufusion_torch import ops

        def body(state, inputs):
            ops.add_launch_counts({"styled_conv": 9, "pgd_update": 1})
            state["x"].add_(1)
        prog = graphs.StepProgram(body, dict(x=torch.zeros(2)), {}, limit=limit)
        prog.device = torch.device("cuda")
        return prog
    yield audit, program, rows
    audit.uninstall()
    from tpufusion_torch import ops

    ops.reset_launch_counts()


def test_launch_audit_reads_replays_at_their_measured_counts(smoke, audited):
    audit, program, rows = audited
    smoke.reset_counts()
    prog = program()
    prog.run(4)  # one eager step, the capture, a profiled replay, two replays
    assert audit.audited == 1 and audit.per_replay[prog]["styled_conv"] == 9
    counts = smoke.read_counts()
    assert counts["styled_conv"] == 36 and counts["pgd_update"] == 4
    assert audit.booked["styled_conv"] == 27 == audit.measured["styled_conv"]
    prog.run(2)  # measured already: no profile
    assert audit.audited == 1 and smoke.read_counts()["pgd_update"] == 6
    # the launches of a comparison leave the counts as they were
    with smoke.uncounted():
        prog.run(2)
    assert smoke.read_counts()["pgd_update"] == 6


def test_launch_audit_waits_out_a_paused_call(smoke, audited):
    audit, program, rows = audited
    smoke.reset_counts()
    prog = program()
    with smoke.audit_paused():
        prog.run(3)
    assert audit.audited == 0 and audit.pending[prog] == 2
    with pytest.raises(SystemExit):
        smoke.read_counts()  # replays in the counted run, never measured
    assert audit.measure(prog) == 1 and audit.measure(prog) == 0
    assert not audit.pending and smoke.read_counts()["styled_conv"] == 36
    # untracked outside a counted run, refused inside one
    other = program()
    with smoke.audit_paused(track=False):
        other.run(2)
    with pytest.raises(SystemExit):
        smoke.read_counts()
    smoke.reset_counts()
    assert smoke.read_counts()["styled_conv"] == 0


def test_launch_audit_fails_a_replay_that_launches_otherwise(smoke, audited):
    audit, program, rows = audited
    rows[0] = [(STYLED_ROW, 1.0, 8), (PGD_ROW, 0.1, 1)]
    with pytest.raises(SystemExit):
        program().run(2)


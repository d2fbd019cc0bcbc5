#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``tpufusion_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the CUDA sources under ``tpufusion_torch/csrc`` compile into
   ``build/tpufusion_torch`` (one nvcc per source, in parallel);
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes, in float32 (TF32 off) and bfloat16, with times;
4. a small-input reference: a 32^2 pipeline on the card (fp32 policy, through
   the kernels) against the same weights on the CPU (plain versions);
5. the main path at full width: the FFHQ 1024^2 config-f generator + e4e
   IR-SE-50 pipeline (seeded random weights), one fused-image forward, FGSM,
   and PGD with the default eps/alpha for 5 steps after a warm-up, with every
   kernel's launch count read around that run;
6. device time by kernel for one PGD step, from torch.profiler;
7. the kernels line (JSON, one object) and the last line
   ``{"ok": true, "device": {...}}``.

Per-shape kernel numbers also go to ``runs/chip_smoke/chip_smoke_kernels.json``.
This script imports nothing of JAX or of the JAX package ``tpufusion``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bytes/s and operations/s by type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=10, warmup=2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

STYLED_SHAPES = [(4, 512), (8, 512), (16, 512), (32, 512), (64, 512), (128, 256),
                 (256, 128), (512, 64), (1024, 32)]
CONV_SHAPES = [(1, 1024, 32), (1, 512, 64), (2, 512, 64)]
MAIN_CONV_SHAPES = [(1, 1024, 32), (1, 512, 64)]  # batch-1 fused image
TOL = {"float32": 1e-3, "bfloat16": 3e-2}  # on max|err| / max(1, max|plain|)
# pgd_update repeats its plain version's float32 operations one for one and
# rounds once at the store, so it must agree bit for bit in both dtypes: any
# looser bound in bf16 would pass a kernel that drops the alpha * sign(g) step.
TOL_PGD = {"float32": 0.0, "bfloat16": 0.0}


def _err(torch, got, ref):
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        return math.inf, 0.0
    err = (got - ref).abs().max().item()
    return err, err / max(1.0, ref.abs().max().item())


def check_kernels(torch, records):
    """Every kernel against its plain twin; returns the per-kernel summary."""
    from tpufusion_torch.ops import conv3x3 as c3
    from tpufusion_torch.ops import pgd_update as pu
    from tpufusion_torch.ops import styled_conv as sc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []

    def rn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def record(kernel, case, dtype, err, rel, ms=None, plain=None, lib=None, nbytes=0,
               ops=0):
        tol = (TOL_PGD if kernel == "pgd_update" else TOL)[dtype]
        ok = rel <= tol
        b, by = bound_ms(nbytes, ops, dtype) if nbytes else (None, None)
        records.append(dict(kernel=kernel, case=case, dtype=dtype, max_abs_err=err,
                            rel_err=rel, tol=tol, ok=ok, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=b, bound_by=by))
        log(f"  {kernel:14s} {case:22s} {dtype:8s} max_abs_err {err:.3e} "
            f"(rel {rel:.3e}, tol {tol:.0e}) {'ok' if ok else 'FAIL'}"
            + (f"  kernel {ms:.4f} ms plain {plain:.4f} ms bound {b:.4f} ms ({by})"
               if ms is not None else "")
            + (f" library {lib:.4f} ms" if lib is not None else ""))
        if not ok:
            failures.append(f"{kernel} {case} {dtype}: rel err {rel:.3e} > {tol}")

    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        isz = torch.tensor([], dtype=dt).element_size()
        # styled conv: the 9 synthesis shapes, batch 1 and 2
        for n in (1, 2):
            for res, ch in STYLED_SHAPES:
                x = rn(n, res, res, ch, dtype=dt)
                w = rn(3, 3, ch, ch, dtype=torch.float32)
                s = rn(n, ch, dtype=torch.float32) * 0.5 + 1.0
                noise = rn(1, res, res, 1, dtype=torch.float32)
                ns = torch.tensor(0.1, device=dev)
                b = rn(ch, dtype=torch.float32) * 0.1
                args = (x, w, s, noise, ns, b)
                y = sc.styled_conv_kernel(*args)
                torch.cuda.synchronize()
                err, rel = _err(torch, y, sc.styled_conv_plain(*args))
                timed = dtype_name == "bfloat16" and n == 1
                ms = time_ms(torch, lambda: sc.styled_conv_kernel(*args)) if timed else None
                plain = time_ms(torch, lambda: sc.styled_conv_plain(*args)) if timed else None
                record("styled_conv", f"n{n} {res}^2 c{ch}", dtype_name, err, rel, ms, plain,
                       nbytes=n * res * res * 2 * ch * isz + 9 * ch * ch * isz,
                       ops=2 * 9 * ch * ch * n * res * res)
        # low-channel conv: forward, input grad, weight grad
        for n, res, ch in CONV_SHAPES:
            x = rn(n, res, res, ch, dtype=dt)
            w = (rn(3, 3, ch, ch, dtype=torch.float32) / math.sqrt(9 * ch)).to(dt)
            g = rn(n, res, res, ch, dtype=dt)
            timed = dtype_name == "bfloat16" and (n, res, ch) in MAIN_CONV_SHAPES
            act = n * res * res * ch * isz
            ops = 2 * 9 * ch * ch * n * res * res
            case = f"n{n} {res}^2 c{ch}"
            xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            wn = w.permute(3, 2, 0, 1).contiguous()

            y = c3.conv3x3_forward_kernel(x, w)
            torch.cuda.synchronize()
            err, rel = _err(torch, y, c3.conv3x3_plain(x, w))
            record("conv3x3_fwd", case, dtype_name, err, rel,
                   *((time_ms(torch, lambda: c3.conv3x3_forward_kernel(x, w)),
                      time_ms(torch, lambda: c3.conv3x3_plain(x, w)),
                      time_ms(torch, lambda: torch.nn.functional.conv2d(xn, wn, padding=1)))
                     if timed else (None, None, None)),
                   nbytes=2 * act + 9 * ch * ch * isz, ops=ops)

            dx = c3.conv3x3_input_grad_kernel(g, w)
            torch.cuda.synchronize()
            err, rel = _err(torch, dx, c3.conv3x3_input_grad_plain(g, w))
            record("conv3x3_dgrad", case, dtype_name, err, rel,
                   *((time_ms(torch, lambda: c3.conv3x3_input_grad_kernel(g, w)),
                      time_ms(torch, lambda: c3.conv3x3_input_grad_plain(g, w)),
                      time_ms(torch, lambda: torch.nn.grad.conv2d_input(
                          xn.shape, wn, gn, padding=1)))
                     if timed else (None, None, None)),
                   nbytes=2 * act + 9 * ch * ch * isz, ops=ops)

            dw = c3.conv3x3_weight_grad_kernel(x, g)
            torch.cuda.synchronize()
            err, rel = _err(torch, dw, c3.conv3x3_weight_grad_plain(x, g))
            record("conv3x3_wgrad", case, dtype_name, err, rel,
                   *((time_ms(torch, lambda: c3.conv3x3_weight_grad_kernel(x, g)),
                      time_ms(torch, lambda: c3.conv3x3_weight_grad_plain(x, g)),
                      time_ms(torch, lambda: torch.nn.grad.conv2d_weight(
                          xn, wn.shape, gn, padding=1)))
                     if timed else (None, None, None)),
                   nbytes=2 * act + 9 * ch * ch * 4, ops=ops)
        # PGD update: the main-path shape and an odd size
        for shape in ((2, 1024, 1024, 3), (3, 37, 53, 3)):
            adv = rn(*shape, dtype=dt).clamp(-1, 1)
            img = (adv.float() + 0.01 * rn(*shape, dtype=torch.float32)).clamp(-1, 1).to(dt)
            grd = rn(*shape, dtype=dt)
            args = (adv, grd, img, 0.02, 16 / 255, -1.0, 1.0)
            out = pu.pgd_update_kernel(*args)
            torch.cuda.synchronize()
            err, rel = _err(torch, out, pu.pgd_update_plain(*args))
            timed = dtype_name == "float32" and shape[1] == 1024
            numel = adv.numel()
            record("pgd_update", "x".join(map(str, shape)), dtype_name, err, rel,
                   time_ms(torch, lambda: pu.pgd_update_kernel(*args)) if timed else None,
                   time_ms(torch, lambda: pu.pgd_update_plain(*args)) if timed else None,
                   nbytes=4 * numel * isz, ops=7 * numel)
    torch.backends.cudnn.allow_tf32 = True
    if failures:
        fail("kernel disagrees with its plain version: " + "; ".join(failures))


def _numbers(rs):
    """Worst errors (over every case, and by dtype) and the time, bound,
    plain and library times summed over the timed (main-path, bf16 or fp32
    for pgd) shapes of ``rs``."""
    timed = [r for r in rs if r["ms"] is not None]
    lib = [r["library_ms"] for r in timed]
    bound = sum(r["bound_ms"] for r in timed)
    by_bytes = sum(r["bound_ms"] for r in timed if r["bound_by"] == "bytes")
    return {
        "max_abs_err": max(r["max_abs_err"] for r in rs),
        "max_err_fp32": max(r["max_abs_err"] for r in rs if r["dtype"] == "float32"),
        "max_err_bf16": max(r["max_abs_err"] for r in rs if r["dtype"] == "bfloat16"),
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": bound,
        "bound_by": "bytes" if by_bytes >= bound - by_bytes else "operations",
        "library_ms": sum(lib) if lib and None not in lib else None,
        "shapes_timed": [f"{r['case']} {r['dtype']}" for r in timed],
    }


def summarize(records, launches, per_step):
    """One entry per kernel source: main-path launches and ``_numbers``.
    conv3x3's entry times its on-path launches (forward and input grad, what
    a PGD step runs) and lists each of its three kernels under ``parts``; the
    weight grad is off the path (the attack freezes the weights)."""
    def of(*names):
        return [r for r in records if r["kernel"] in names]

    pallas_conv = "tpufusion/ops/pallas_conv.py"
    parts = {
        "forward": ("conv3x3_fwd", f"{pallas_conv}:195"),
        "input_grad": ("conv3x3_dgrad", f"{pallas_conv}:195"),
        "weight_grad": ("conv3x3_wgrad", f"{pallas_conv}:284"),
    }
    conv3x3 = {
        "name": "conv3x3", "route": "cuda", "source": "tpufusion_torch/csrc/conv3x3.cu",
        "replaces": f"{pallas_conv}:195",
        "launches": sum(launches[k] for k, _ in parts.values()),
        **_numbers(of("conv3x3_fwd", "conv3x3_dgrad")),
        "launches_per_pgd_step": sum(per_step[k] for k, _ in parts.values()),
        "parts": {p: {"replaces": rep, "launches": launches[k],
                      "launches_per_pgd_step": per_step[k], **_numbers(of(k))}
                  for p, (k, rep) in parts.items()},
    }
    return [
        {"name": "styled_conv", "route": "cuda",
         "source": "tpufusion_torch/csrc/styled_conv.cu",
         "replaces": "tpufusion/ops/styled_conv.py:139",
         "launches": launches["styled_conv"], **_numbers(of("styled_conv")),
         "launches_per_pgd_step": per_step["styled_conv"]},
        conv3x3,
        {"name": "pgd_update", "route": "cuda",
         "source": "tpufusion_torch/csrc/pgd_update.cu",
         "replaces": "tpufusion/ops/pgd_update.py:104",
         "launches": launches["pgd_update"], **_numbers(of("pgd_update")),
         "launches_per_pgd_step": per_step["pgd_update"]},
    ]


# ---------------------------------------------------------------------------
# phase 4: small-input reference (card through the kernels vs CPU plain)
# ---------------------------------------------------------------------------

def check_small_reference(torch):
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, make_fused_image_fn, make_fusion_loss)
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.pipeline import FusionPipeline

    torch.backends.cudnn.allow_tf32 = False
    kw = dict(size=32, channel_multiplier=1, encoder_base_channels=16,
              encoder_units=(1, 1, 1, 1), encoder_input_size=32, mean_latent_samples=64,
              policy=Policy(), seed=3)
    cpu = FusionPipeline.create("ffhq", device="cpu", **kw)
    gpu = FusionPipeline.create("ffhq", device="cuda", **kw)
    gpu.generator.load_state_dict(cpu.generator.state_dict())
    gpu.encoder.load_state_dict(cpu.encoder.state_dict())
    gpu.latent_avg = cpu.latent_avg.cuda()
    gen = torch.Generator().manual_seed(4)
    x = torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1
    t = torch.rand((1, 32, 32, 3), generator=gen) * 2 - 1
    with torch.no_grad():
        f_cpu = make_fused_image_fn(cpu)(x)
        f_gpu = make_fused_image_fn(gpu)(x.cuda()).cpu()
    err = (f_cpu - f_gpu).abs().max().item()
    log(f"  small reference: fused 32^2 card vs CPU max_abs_err {err:.3e} (tol 2e-3)")
    if not (math.isfinite(err) and err <= 2e-3):
        fail(f"32^2 fused image on the card disagrees with the CPU: {err}")
    grads = []
    for p, dev in ((cpu, "cpu"), (gpu, "cuda")):
        loss_fn = make_fusion_loss(p, FusionAttackConfig())
        xa = x.to(dev).requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(xa, t.to(dev)), xa)
        grads.append(g.cpu())
    rel = ((grads[0] - grads[1]).abs().max() / grads[0].abs().max()).item()
    log(f"  small reference: loss grad card vs CPU rel err {rel:.3e} (tol 1e-2)")
    if not (math.isfinite(rel) and rel <= 1e-2):
        fail(f"32^2 attack gradient on the card disagrees with the CPU: {rel}")
    torch.backends.cudnn.allow_tf32 = True


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def run_main_path(torch, card):
    from tpufusion_torch import ops
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, fgsm_on_fusion, make_fused_image_fn, make_fusion_attack,
        make_fusion_loss)
    from tpufusion_torch.pipeline import FusionPipeline

    t0 = time.perf_counter()
    pipe = FusionPipeline.create(
        "ffhq", size=1024, channel_multiplier=2, encoder_base_channels=64,
        encoder_units=(3, 4, 14, 3), encoder_input_size=256, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"  pipeline built in {time.perf_counter() - t0:.2f} s "
        f"(config-f 1024^2 generator, e4e IR-SE-50, mean_latent over 4096 z)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = torch.rand((2, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    target = torch.rand((1, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    fused_fn = make_fused_image_fn(pipe)
    cfg = FusionAttackConfig()
    pgd_cfg = dataclasses.replace(cfg, pgd=dataclasses.replace(cfg.pgd, steps=5))
    eps = cfg.pgd.eps

    # warm-up: one forward and one PGD step (cuDNN plans, allocator)
    with torch.no_grad():
        fused_fn(inputs)
    make_fusion_attack(pipe, dataclasses.replace(
        cfg, pgd=dataclasses.replace(cfg.pgd, steps=1)))(inputs, target, gen)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    n_fwd = 3
    with torch.no_grad():
        t0 = time.perf_counter()
        for _ in range(n_fwd):
            fused = fused_fn(inputs)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3 / n_fwd
    fwd_launches = ops.launch_counts()["styled_conv"]
    adv1, tr1 = fgsm_on_fusion(pipe)(inputs, target)
    before_pgd = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adv, trace = make_fusion_attack(pipe, pgd_cfg)(inputs, target, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / pgd_cfg.pgd.steps
    launches = ops.launch_counts()
    per_step = {k: (launches[k] - before_pgd[k]) / pgd_cfg.pgd.steps for k in launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        final_loss = make_fusion_loss(pipe, cfg)(adv, target).item()

    if tuple(fused.shape) != (1, 1024, 1024, 3) or not torch.isfinite(fused).all():
        fail(f"fused image has shape {tuple(fused.shape)} or non-finite values")
    trace = trace.float().cpu().tolist()
    for name, a in (("fgsm", adv1), ("pgd", adv)):
        dev_max = (a - inputs).abs().max().item()
        if not torch.isfinite(a).all() or dev_max > eps + 1e-6:
            fail(f"{name}: adv leaves the eps-ball ({dev_max} > {eps})")
    if not all(math.isfinite(v) for v in trace + [final_loss, tr1.item()]):
        fail(f"non-finite loss: {trace}, {final_loss}")
    if not final_loss < trace[0]:
        fail(f"loss did not descend: {trace[0]} -> {final_loss}")
    steps = 1 + pgd_cfg.pgd.steps  # FGSM + PGD
    need = {"styled_conv": 9 * (n_fwd + steps), "conv3x3_fwd": 2 * steps,
            "conv3x3_dgrad": 2 * steps, "pgd_update": steps}
    for name, n_min in need.items():
        if launches[name] < n_min:
            fail(f"main path launched {name} {launches[name]} times, expected >= {n_min}")
    if fwd_launches != 9 * n_fwd:
        fail(f"{n_fwd} fused forwards launched styled_conv {fwd_launches} times, "
             f"expected {9 * n_fwd}")
    log(f"  fused_forward_ms {fwd_ms:.3f} [{card}] (mean of {n_fwd})")
    log(f"  pgd_step_ms {step_ms:.3f} [{card}] (N=2 inputs, 1024^2, bf16, 5 steps)")
    log(f"  peak_memory_gib {peak_gib:.3f} [{card}]")
    log(f"  loss trace {trace} -> final {final_loss:.6f}; fgsm loss {tr1.item():.6f}")
    log(f"  launches {launches} ({n_fwd} fused forwards: styled_conv {fwd_launches}; "
        f"per PGD step {per_step})")
    return launches, per_step, dict(fused_forward_ms=fwd_ms, pgd_step_ms=step_ms,
                                 peak_memory_gib=peak_gib, loss_trace=trace,
                                 final_loss=final_loss), (pipe, cfg, inputs, target, gen)


KERNEL_NAMES = (("conv3x3_fwd_kernel<float, true>", "styled_conv"),
                ("conv3x3_fwd_kernel<__nv_bfloat16, true>", "styled_conv"),
                ("conv3x3_fwd_kernel", "conv3x3_fwd/dgrad"),
                ("conv3x3_wgrad_kernel", "conv3x3_wgrad"),
                ("sum_partials_kernel", "conv3x3_wgrad"),
                ("pgd_kernel", "pgd_update"))


def profile_step(torch, pipe, cfg, inputs, target, gen, *, step_ms):
    """Device time by kernel for one PGD step (after a warm-up step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpufusion_torch.attacks.fusion_attack import make_fusion_attack

    attack = make_fusion_attack(pipe, dataclasses.replace(
        cfg, pgd=dataclasses.replace(cfg.pgd, steps=1)))
    attack(inputs, target, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        attack(inputs, target, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)) / 1e3
        if ms > 0:
            rows.append((e.key, ms, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        log("  the profiler saw no device time (not measured)")
        return dict(wall_ms=wall_ms, device_ms=None)
    groups: dict = {}
    for key, ms, _ in rows:
        group = next((g for pat, g in KERNEL_NAMES if pat in key), "other kernels")
        groups[group] = groups.get(group, 0.0) + ms
    log(f"  step wall {wall_ms:.3f} ms with the profiler on, device busy {busy:.3f} ms: "
        f"idle share {1 - busy / wall_ms:.3f} of the profiled step, "
        f"{1 - busy / step_ms:.3f} of the unprofiled pgd_step_ms {step_ms:.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:20s} {ms:9.3f} ms  {ms / busy:6.1%}")
    log("  top kernels:")
    for key, ms, count in rows[:12]:
        log(f"    {ms:9.3f} ms  x{count:<4d} {key[:110]}")
    return dict(wall_ms=wall_ms, device_ms=busy, idle_share=1 - busy / step_ms,
                groups=groups,
                top=[dict(kernel=k, ms=ms, count=c) for k, ms, c in rows[:40]])


def main() -> None:
    if not os.path.isfile(os.path.join(HERE, "tpufusion_torch", "__init__.py")):
        fail("tpufusion_torch/ not found beside chip_smoke.py: run it from a checkout")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the card")
    sys.path.insert(0, HERE)

    log("== 1. environment")
    card = card_line()
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"  card: {card}")

    log("== 2. build")
    from tpufusion_torch.ops import _lib

    secs = _lib.build()
    log(f"  built {', '.join(_lib.SOURCES)} in {secs:.2f} s -> {_lib.BUILD_DIR}")

    log("== 3. kernels against their plain versions")
    records = []
    check_kernels(torch, records)

    log("== 4. small-input reference (card vs CPU)")
    check_small_reference(torch)

    log("== 5. main path: FFHQ 1024^2 fusion attack, full width")
    launches, per_step, main_numbers, attack_args = run_main_path(torch, card)

    log("== 6. where the time goes: one PGD step under torch.profiler")
    profile = profile_step(torch, *attack_args, step_ms=main_numbers["pgd_step_ms"])

    kernels = summarize(records, launches, per_step)
    out_dir = os.path.join(HERE, "runs", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_kernels.json"), "w") as f:
        json.dump(dict(card=card, records=records, kernels=kernels, main=main_numbers,
                       profile=profile), f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

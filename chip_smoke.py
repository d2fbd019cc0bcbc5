#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``tpufusion_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the CUDA sources under ``tpufusion_torch/csrc`` compile into
   ``build/tpufusion_torch`` (one nvcc per source, in parallel);
3. kernels against their plain PyTorch versions on the card, at the shapes
   of both main paths (fusion PGD, batch 1 synthesis; white-box, batch 5),
   in float32 (TF32 off) and bfloat16, with times;
4. a small-input reference: a 32^2 pipeline on the card (fp32 policy, through
   the kernels) against the same weights on the CPU (plain versions): the
   fused image, the pixel and 'vgg' objectives' gradients, and a 3-iteration
   white-box attack;
5. the fusion main path at full width: the FFHQ 1024^2 config-f generator +
   e4e IR-SE-50 + VGG16 pipeline (seeded random weights), one fused-image
   forward, FGSM, and PGD with the default eps/alpha for 5 steps after a
   warm-up, with every kernel's launch count read around that run;
5b. the white-box main path at full width on the same pipeline
   (``configs/ffhq_whitebox.json``: N = 5 inputs all attacked toward one
   target, PRESET_ATTACK_MAIN, lr 1e-4): one warm-up iteration, then a
   5-iteration ``run_whitebox`` with the launch counts read around it;
6. device time by kernel for one PGD step and one white-box step, from
   torch.profiler;
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
# the synthesis batch of each main path, by the path's name
STYLED_BATCHES = {1: "pgd", 2: None, 5: "whitebox"}
CONV_SHAPES = {(1, 1024, 32): "pgd", (1, 512, 64): "pgd", (2, 512, 64): None,
               (5, 1024, 32): "whitebox", (5, 512, 64): "whitebox"}
ADAM_SHAPES = {(5, 1024, 1024, 3): "whitebox", (3, 37, 53, 3): None}
TOL = {"float32": 1e-3, "bfloat16": 3e-2}  # on max|err| / max(1, max|plain|)
# pgd_update and fused_adam repeat their plain versions' float32 operations
# one for one, so they must agree bit for bit: any looser bound in bf16 would
# pass a pgd kernel that drops the alpha * sign(g) step, and an Adam step of
# lr 1e-4 is below the float32 bound's resolution.
EXACT = {"pgd_update", "fused_adam"}


def _err(torch, got, ref):
    """``(max|got - ref|, that over max(1, max|ref|))``; both are inf when
    ``got`` holds a NaN or an Inf."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        return math.inf, math.inf
    err = (got - ref).abs().max().item()
    return err, err / max(1.0, ref.abs().max().item())


def _within(err: float, rel: float, tol: float) -> bool:
    """A kernel agrees with its plain version: finite errors, ``rel <= tol``."""
    return math.isfinite(err) and math.isfinite(rel) and rel <= tol


def check_kernels(torch, records):
    """Every kernel against its plain twin; returns the per-kernel summary."""
    from tpufusion_torch.ops import adam_update as au
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
               ops=0, path=None):
        tol = 0.0 if kernel in EXACT else TOL[dtype]
        ok = _within(err, rel, tol)
        b, by = bound_ms(nbytes, ops, dtype) if nbytes else (None, None)
        records.append(dict(kernel=kernel, case=case, dtype=dtype, max_abs_err=err,
                            rel_err=rel, tol=tol, ok=ok, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=b, bound_by=by,
                            path=path if ms is not None else None))
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
        # styled conv: the 9 synthesis shapes, at each path's batch
        for n, path in STYLED_BATCHES.items():
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
                timed = dtype_name == "bfloat16" and path is not None
                ms = time_ms(torch, lambda: sc.styled_conv_kernel(*args)) if timed else None
                plain = time_ms(torch, lambda: sc.styled_conv_plain(*args)) if timed else None
                record("styled_conv", f"n{n} {res}^2 c{ch}", dtype_name, err, rel, ms, plain,
                       nbytes=n * res * res * 2 * ch * isz + 9 * ch * ch * isz,
                       ops=2 * 9 * ch * ch * n * res * res, path=path)
        # low-channel conv: forward, input grad, weight grad
        for (n, res, ch), path in CONV_SHAPES.items():
            x = rn(n, res, res, ch, dtype=dt)
            w = (rn(3, 3, ch, ch, dtype=torch.float32) / math.sqrt(9 * ch)).to(dt)
            g = rn(n, res, res, ch, dtype=dt)
            timed = dtype_name == "bfloat16" and path is not None
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
                   nbytes=2 * act + 9 * ch * ch * isz, ops=ops, path=path)

            dx = c3.conv3x3_input_grad_kernel(g, w)
            torch.cuda.synchronize()
            err, rel = _err(torch, dx, c3.conv3x3_input_grad_plain(g, w))
            record("conv3x3_dgrad", case, dtype_name, err, rel,
                   *((time_ms(torch, lambda: c3.conv3x3_input_grad_kernel(g, w)),
                      time_ms(torch, lambda: c3.conv3x3_input_grad_plain(g, w)),
                      time_ms(torch, lambda: torch.nn.grad.conv2d_input(
                          xn.shape, wn, gn, padding=1)))
                     if timed else (None, None, None)),
                   nbytes=2 * act + 9 * ch * ch * isz, ops=ops, path=path)

            dw = c3.conv3x3_weight_grad_kernel(x, g)
            torch.cuda.synchronize()
            err, rel = _err(torch, dw, c3.conv3x3_weight_grad_plain(x, g))
            record("conv3x3_wgrad", case, dtype_name, err, rel,
                   *((time_ms(torch, lambda: c3.conv3x3_weight_grad_kernel(x, g)),
                      time_ms(torch, lambda: c3.conv3x3_weight_grad_plain(x, g)),
                      time_ms(torch, lambda: torch.nn.grad.conv2d_weight(
                          xn, wn.shape, gn, padding=1)))
                     if timed else (None, None, None)),
                   nbytes=2 * act + 9 * ch * ch * 4, ops=ops, path=path)
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
                   nbytes=4 * numel * isz, ops=7 * numel, path="pgd")
    # fused Adam (float32 only): the white-box pixel buffer and an odd size,
    # aligned and 4 bytes off alignment, at steps 1 and 50
    for shape, path in ADAM_SHAPES.items():
        for count in (1, 50):
            bc1, bc2 = au.bias_corrections(count)
            state = [rn(*shape, dtype=torch.float32) for _ in range(4)]
            state[2] *= 0.1
            state[3] = state[3].square() * 0.01
            for off in (0, 1):
                x, g, mu, nu = ([torch.empty(t.numel() + off, device=dev)[off:].copy_(
                    t.reshape(-1)).view(shape) for t in state])
                want = au.adam_update_plain(x.clone(), g, mu.clone(), nu.clone(), 1e-4,
                                            bc1, bc2)
                au.adam_update_kernel(x, g, mu, nu, 1e-4, bc1, bc2)
                torch.cuda.synchronize()
                err = max(_err(torch, a, b)[0] for a, b in zip((x, mu, nu), want))
                timed = path is not None and count == 1 and off == 0
                numel = x.numel()
                case = "x".join(map(str, shape)) + f" t{count}" + (" unaligned" if off else "")
                record("fused_adam", case, "float32", err, err,
                       *((time_ms(torch, lambda: au.adam_update_kernel(x, g, mu, nu, 1e-4,
                                                                     bc1, bc2)),
                          time_ms(torch, lambda: au.adam_update_plain(x, g, mu, nu, 1e-4,
                                                                    bc1, bc2)),
                          _torch_adam_ms(torch, x, g))
                         if timed else (None, None, None)),
                       nbytes=7 * numel * 4, ops=12 * numel, path=path if timed else None)
    torch.backends.cudnn.allow_tf32 = True
    if failures:
        fail("kernel disagrees with its plain version: " + "; ".join(failures))


def _torch_adam_ms(torch, x, g):
    """The library yardstick for one Adam step: ``torch.optim.Adam(fused=True)``
    on the same buffer (timed only; the port never calls it)."""
    p = torch.nn.Parameter(x.clone())
    p.grad = g.clone()
    opt = torch.optim.Adam([p], lr=1e-4, fused=True)
    return time_ms(torch, opt.step)


def _numbers(rs, path="pgd"):
    """Worst errors (over every case, and by dtype) and the time, bound,
    plain and library times summed over the shapes of ``rs`` timed for the
    main path ``path`` (bf16, or fp32 for the pixel updates)."""
    timed = [r for r in rs if r["path"] == path]
    if not timed:
        return {}
    lib = [r["library_ms"] for r in timed]
    bound = sum(r["bound_ms"] for r in timed)
    by_bytes = sum(r["bound_ms"] for r in timed if r["bound_by"] == "bytes")
    errs = {f"max_err_{short}": max(r["max_abs_err"] for r in rs if r["dtype"] == dt)
            for dt, short in (("float32", "fp32"), ("bfloat16", "bf16"))
            if any(r["dtype"] == dt for r in rs)}
    return {
        "max_abs_err": max(r["max_abs_err"] for r in rs),
        **errs,
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": bound,
        "bound_by": "bytes" if by_bytes >= bound - by_bytes else "operations",
        "library_ms": sum(lib) if lib and None not in lib else None,
        "shapes_timed": [f"{r['case']} {r['dtype']}" for r in timed],
    }


def summarize(records, runs):
    """One entry per kernel source: launches on the main paths and
    ``_numbers``. ``runs`` maps each main path ("pgd", "whitebox") to its
    (launch counts, launches per step); ``launches`` is their sum. The
    numbers at the top of an entry are those of the kernel's home path (the
    fusion PGD path, or the white-box path for fused_adam); the other path's
    shapes, where the kernel has some, are under its name. conv3x3's entry
    times its on-path launches (forward and input grad, what an attack step
    runs) and lists each of its three kernels under ``parts``; the weight
    grad is off both paths (the attacks freeze the weights)."""
    def of(*names):
        return [r for r in records if r["kernel"] in names]

    def numbers(kernels, home):
        out = _numbers(of(*kernels), home)
        for path in runs:
            other = _numbers(of(*kernels), path)
            if path != home and other:
                out[path] = other
        return out

    def launches(keys):
        out = {"launches": sum(runs[p][0][k] for p in runs for k in keys)}
        for path, (counts, per_step) in runs.items():
            out[f"launches_{path}_path"] = sum(counts[k] for k in keys)
            out[f"launches_per_{path}_step"] = sum(per_step[k] for k in keys)
        return out

    def entry(name, source, replaces, keys, home="pgd"):
        return {"name": name, "route": "cuda", "source": f"tpufusion_torch/csrc/{source}",
                "replaces": replaces, **launches(keys), **numbers(keys, home)}

    pallas_conv = "tpufusion/ops/pallas_conv.py"
    parts = {
        "forward": ("conv3x3_fwd", f"{pallas_conv}:195"),
        "input_grad": ("conv3x3_dgrad", f"{pallas_conv}:195"),
        "weight_grad": ("conv3x3_wgrad", f"{pallas_conv}:284"),
    }
    conv3x3 = entry("conv3x3", "conv3x3.cu", f"{pallas_conv}:195",
                    ("conv3x3_fwd", "conv3x3_dgrad"))
    conv3x3["launches"] = sum(runs[p][0][k] for p in runs for k, _ in parts.values())
    conv3x3["parts"] = {part: {"replaces": rep, **launches((k,)), **numbers((k,), "pgd")}
                        for part, (k, rep) in parts.items()}
    return [
        entry("styled_conv", "styled_conv.cu", "tpufusion/ops/styled_conv.py:139",
              ("styled_conv",)),
        conv3x3,
        entry("pgd_update", "pgd_update.cu", "tpufusion/ops/pgd_update.py:104",
              ("pgd_update",)),
        entry("fused_adam", "adam_update.cu", "tpufusion/ops/adam_update.py:91",
              ("fused_adam",), home="whitebox"),
    ]


# ---------------------------------------------------------------------------
# phase 4: small-input reference (card through the kernels vs CPU plain)
# ---------------------------------------------------------------------------

def check_small_reference(torch):
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, make_fused_image_fn, make_fusion_loss)
    from tpufusion_torch.attacks.whitebox import (
        PRESET_ATTACK_MAIN, WhiteboxConfig, _make_loss, _make_ref, run_whitebox)
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.pipeline import FusionPipeline

    torch.backends.cudnn.allow_tf32 = False
    kw = dict(size=32, channel_multiplier=1, encoder_base_channels=16,
              encoder_units=(1, 1, 1, 1), encoder_input_size=32, mean_latent_samples=64,
              policy=Policy(), seed=3)
    cpu = FusionPipeline.create("ffhq", device="cpu", **kw)
    gpu = FusionPipeline.create("ffhq", device="cuda", **kw)
    for name in ("generator", "encoder", "vgg"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
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
    for objective in ("pixel", "vgg"):
        grads = []
        for p, dev in ((cpu, "cpu"), (gpu, "cuda")):
            loss_fn = make_fusion_loss(p, FusionAttackConfig(objective=objective))
            xa = x.to(dev).requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(xa, t.to(dev)), xa)
            grads.append(g.cpu())
        rel = ((grads[0] - grads[1]).abs().max() / grads[0].abs().max()).item()
        log(f"  small reference: '{objective}' loss grad card vs CPU rel err {rel:.3e} "
            f"(tol 1e-2)")
        if not (math.isfinite(rel) and rel <= 1e-2):
            fail(f"32^2 '{objective}' attack gradient on the card disagrees with the CPU: "
                 f"{rel}")

    # the white-box attack, 3 iterations: the total trace to 1e-5 relative
    # (an H100 run read 5.95e-07, PERF.md);
    # adv where the first step's |g| > 1e-6 (Adam's first step is
    # lr * g / (|g| + eps): where the gradient vanishes, float noise moves a
    # pixel by up to lr). From the second step Adam divides by each pixel's
    # own gradient history and amplifies the leaky-ReLU-kink differences of
    # the two devices' gradients (tests/test_torch_whitebox.py), so the worst
    # pixel is held to 0.2 lr and the mean to 1e-5.
    lr = 1e-2
    cfg = WhiteboxConfig(lr=lr, n_iters=3)
    outs = [run_whitebox(p, x.to(dev), t.to(dev), cfg) for p, dev in ((cpu, "cpu"),
                                                                      (gpu, "cuda"))]
    tr_cpu, tr_gpu = (o[1]["total"].cpu() for o in outs)
    rel = ((tr_cpu - tr_gpu).abs() / tr_cpu.abs()).max().item()
    ref = _make_ref(cpu)(x, t)
    xa = x.clone().requires_grad_(True)
    total, _ = _make_loss(cpu, PRESET_ATTACK_MAIN, per_image=True)(xa, ref)
    (g,) = torch.autograd.grad(total.sum(), xa)
    mask = g.abs() > 1e-6
    d = (outs[0][0] - outs[1][0].cpu()).abs()[mask]
    log(f"  small reference: white-box 3 iters card vs CPU: total trace rel err {rel:.3e} "
        f"(tol 1e-5); adv where |g| > 1e-6 ({mask.float().mean().item():.3f} of pixels) "
        f"max err {d.max().item():.3e} (tol {0.2 * lr:.0e}), mean {d.mean().item():.3e} "
        f"(tol 1e-5)")
    if not (math.isfinite(rel) and rel <= 1e-5):
        fail(f"32^2 white-box trace on the card disagrees with the CPU: {rel}")
    if not (d.max().item() <= 0.2 * lr and d.mean().item() <= 1e-5):
        fail(f"32^2 white-box adv on the card disagrees with the CPU: {d.max().item()}, "
             f"mean {d.mean().item()}")
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


# ---------------------------------------------------------------------------
# phase 5b: the white-box main path at full width
# ---------------------------------------------------------------------------

WB_N, WB_ITERS, WB_LR = 5, 5, 1e-4  # configs/ffhq_whitebox.json: N=5, lr 1e-4


def run_whitebox_path(torch, card, pipe):
    """``run_whitebox`` on N = 5 1024^2 inputs, all attacked toward one
    target (white_box_target), PRESET_ATTACK_MAIN, lr 1e-4: one warm-up
    iteration, then ``WB_ITERS`` timed iterations with the launch counts set
    to 0 just before and read just after."""
    from tpufusion_torch import ops
    from tpufusion_torch.attacks.whitebox import (
        PRESET_ATTACK_MAIN, WhiteboxConfig, make_whitebox_stepper, run_whitebox)
    from tpufusion_torch.ops.adam_update import B1, B2

    gen = torch.Generator(device="cuda").manual_seed(5)
    inputs = torch.rand((WB_N, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    target = torch.rand((1, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    cfg = WhiteboxConfig(lr=WB_LR, n_iters=WB_ITERS, weights=PRESET_ATTACK_MAIN)
    run_whitebox(pipe, inputs, target, dataclasses.replace(cfg, n_iters=1))  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    adv, trace = run_whitebox(pipe, inputs, target, cfg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / WB_ITERS
    launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {k: v / WB_ITERS for k, v in launches.items()}

    totals = trace["total"].float().cpu()
    if tuple(adv.shape) != tuple(inputs.shape):
        fail(f"white-box adv has shape {tuple(adv.shape)}")
    for k, v in trace.items():
        if tuple(v.shape) != (WB_N, WB_ITERS) or not torch.isfinite(v).all():
            fail(f"white-box trace {k}: shape {tuple(v.shape)} or non-finite values")
    moved = (adv - inputs).abs().max().item()
    adam_bound = WB_ITERS * WB_LR * (1 - B1) / math.sqrt(1 - B2)
    if not (torch.isfinite(adv).all() and 0 < moved <= adam_bound + 1e-6):
        fail(f"white-box pixels moved {moved}, expected in (0, {adam_bound}]")
    need = {"fused_adam": WB_ITERS, "styled_conv": 9 * WB_ITERS,
            "conv3x3_fwd": 2 * WB_ITERS, "conv3x3_dgrad": 2 * WB_ITERS}
    if launches["fused_adam"] != WB_ITERS:
        fail(f"{WB_ITERS} white-box iterations launched fused_adam "
             f"{launches['fused_adam']} times")
    for name, n_min in need.items():
        if launches[name] < n_min:
            fail(f"white-box path launched {name} {launches[name]} times, expected >= {n_min}")
    # the total falls for every image: by 8.8-9.8% over 5 iterations at lr
    # 1e-4 in the first run on the card, each step lower than the last, far
    # above the bf16 compute's noise
    first, last = totals[:, 0], totals[:, -1]
    if not bool((last < first).all()):
        fail(f"white-box total did not fall for every image: {first.tolist()} -> "
             f"{last.tolist()}")
    log(f"  whitebox_step_ms {step_ms:.3f} [{card}] (N={WB_N} inputs, 1024^2, bf16, "
        f"mean of a {WB_ITERS}-iteration run_whitebox, its reference bundle included)")
    log(f"  whitebox_peak_memory_gib {peak_gib:.3f} [{card}]")
    log(f"  per-image total trace {totals.tolist()}")
    log(f"  pixels moved at most {moved:.6e} (Adam bound {adam_bound:.6e}); total fell "
        f"for every image: {first.tolist()} -> {last.tolist()}")
    log(f"  launches {launches} (per white-box iteration {per_step})")

    # one stepper state for phase 6's profile of a single white-box step
    init, step = make_whitebox_stepper(pipe, cfg, per_image=True)
    state = init(inputs, target)
    return launches, per_step, dict(
        whitebox_step_ms=step_ms, whitebox_peak_memory_gib=peak_gib,
        whitebox_total_trace=totals.tolist(), whitebox_moved_max=moved,
        whitebox_adam_bound=adam_bound), lambda: step(state)


KERNEL_NAMES = (("conv3x3_fwd_kernel<float, true>", "styled_conv"),
                ("conv3x3_fwd_kernel<__nv_bfloat16, true>", "styled_conv"),
                ("conv3x3_fwd_kernel", "conv3x3_fwd/dgrad"),
                ("conv3x3_wgrad_kernel", "conv3x3_wgrad"),
                ("sum_partials_kernel", "conv3x3_wgrad"),
                ("pgd_kernel", "pgd_update"),
                ("adam_kernel", "fused_adam"))


def profile_step(torch, run, *, step_ms, what):
    """Device time by kernel for one call of ``run`` (one attack step, after
    a warm-up call), against the unprofiled step time ``step_ms`` of the
    metric named ``what``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
        f"{1 - busy / step_ms:.3f} of the unprofiled {what} {step_ms:.3f}")
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

    log("== 5b. main path: FFHQ 1024^2 white-box attack, N=5, full width")
    wb_launches, wb_per_step, wb_numbers, wb_step = run_whitebox_path(
        torch, card, attack_args[0])
    main_numbers.update(wb_numbers)

    from tpufusion_torch.attacks.fusion_attack import make_fusion_attack

    pipe, cfg, inputs, target, gen = attack_args
    pgd_step = make_fusion_attack(pipe, dataclasses.replace(
        cfg, pgd=dataclasses.replace(cfg.pgd, steps=1)))
    log("== 6. where the time goes: one PGD step under torch.profiler")
    profile = profile_step(torch, lambda: pgd_step(inputs, target, gen),
                           step_ms=main_numbers["pgd_step_ms"], what="pgd_step_ms")
    log("== 6b. where the time goes: one white-box step under torch.profiler")
    wb_profile = profile_step(torch, wb_step, step_ms=main_numbers["whitebox_step_ms"],
                              what="whitebox_step_ms")

    kernels = summarize(records, {"pgd": (launches, per_step),
                                  "whitebox": (wb_launches, wb_per_step)})
    out_dir = os.path.join(HERE, "runs", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_kernels.json"), "w") as f:
        json.dump(dict(card=card, records=records, kernels=kernels, main=main_numbers,
                       profile=profile, whitebox_profile=wb_profile), f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

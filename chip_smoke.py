#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``tpufusion_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the CUDA sources under ``tpufusion_torch/csrc`` compile into
   ``build/tpufusion_torch`` (one nvcc per source, in parallel); the conv
   kernels' registers and spills, from ptxas;
3. kernels against their plain PyTorch versions on the card, at the shapes
   of the main paths (fusion PGD, batch 1 synthesis; white-box, batch 5;
   spatial fusion: batch 1 in the attack, batch 6 in the partial-fusion
   evaluation, 5 inputs for pgd_update; classifier transfer: pgd_update and
   fused_adam on 8 x 1024^2 x 3, pgd_update on 8 x 512^2 x 3 untimed),
   in float32 (TF32 off) and bfloat16, with times, and untimed at the
   ragged tile edges of the bf16 tensor-core conv kernels; the weight grad
   also at tiny and ragged planes where the border is a large share of the
   sum, to its own 1e-3 limit, with two launches giving the same bits;
   beside styled_conv, cuDNN's conv core (``conv_core_library_ms``);
3b. the weight grad through the real call chain: ``styled_conv`` with a
   weight that requires grad at the two tail shapes (batch 1 and 5, bf16)
   against autograd through ``styled_conv_plain``, then one full-width
   ``Generator`` forward and backward with its parameters requiring grad,
   with the weight-grad launches counted (run after phase 6b, so that the
   main paths' times and peak memories are taken as before);
4. a small-input reference: a 32^2 pipeline on the card (fp32 policy, through
   the kernels) against the same weights on the CPU (plain versions): the
   fused image, the pixel and 'vgg' objectives' gradients, and a 3-iteration
   white-box attack whose pixels are held, on the card and on the CPU, to a
   float64 CPU run with a per-pixel margin read from that run's own change
   under a 1e-6 move of the inputs; then the spatial fused image of 5
   inputs and its pixel and 'vgg' gradients; a patch step (max_count 2,
   with and without the reconstruction terms), the LPIPS distance and 2
   iterations of each legacy optimize variant; a width-8 resnet and the
   tiny ViT (logits, pixel gradients, 5 classifier PGD steps), a 10-step CW
   run where images succeed, the 32^2 discriminator at batches 4 and 3, and
   the 32^2 pipeline saved and loaded on the card (bit-identical fusions);
5. the fusion main path at full width: the FFHQ 1024^2 config-f generator +
   e4e IR-SE-50 + VGG16 pipeline (seeded random weights), one fused-image
   forward, FGSM, and PGD with the default eps/alpha for 5 steps after a
   warm-up, with every kernel's launch count read around that run;
5b. the white-box main path at full width on the same pipeline
   (``configs/ffhq_whitebox.json``: N = 5 inputs all attacked toward one
   target, PRESET_ATTACK_MAIN, lr 1e-4): one warm-up iteration, then a
   5-iteration ``run_whitebox`` with the launch counts read around it;
5c. the spatial-fusion main path at full width on the same pipeline
   (BASELINE config 3: N = 5 role inputs, VGG objective, default eps and
   alpha): three fused forwards, FGSM and 5 PGD steps, then the
   partial-fusion evaluation (both modes, the N+1 variants as one batch 6
   synthesis) and its metrics, with the launch counts read around it all;
5d. patch training, the baselines, the hybrid splice and the legacy
   optimize at full width on the same pipeline (N = 5 inputs plus a
   target): a square patch trained on 2 images x 5 inner steps and a circle
   patch on 1 x 2, the square one applied to the inputs and fused (both
   modes, the partial fusions too), ``white_box_patch`` (3 iterations
   toward per-image paste targets), blur at the runner's k = 409, dp noise,
   paste and the out-of-domain inputs, the hybrid splice of blur and dp,
   all fused; both legacy variants on one image, 3 iterations; the launch
   counts read around it all;
5e. the classifier-transfer path at full width on the same pipeline
   (``configs/ffhq_classifier_transfer.json``, seeded random classifier
   weights): classifier PGD against a resnet18 (2-way head, 256^2 input) on
   8 1024^2 images, 100 steps; CW (c 1e-4, 200 steps, then 20 steps at
   c 1e4); PGD against ViT-B/16 (196 labels) on 8 512^2 images, 100 steps;
   the first five clean and PGD crops fused in both modes with the partial
   fusions; a config-f 1024^2 discriminator scoring the clean and
   adversarial fusions; the launch counts read around it all;
6. device time by kernel for one PGD step, one white-box step (6b), one
   spatial PGD step (6c), one patch batch (6d) and one classifier PGD
   step, CW step, ViT PGD step and realism batch (6e), from torch.profiler,
   with the step's kernel launches; 6c also times one full-width blender
   forward + backward;
7. the kernels line (JSON, one object) and the last line
   ``{"ok": true, "device": {...}}``.

Per-shape kernel numbers also go to ``runs/chip_smoke/chip_smoke_kernels.json``.
This script imports nothing of JAX or of the JAX package ``tpufusion``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
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
STYLED_BATCHES = {1: "pgd", 2: None, 5: "whitebox", 6: "spatial"}
CONV_SHAPES = {(1, 1024, 32): "pgd", (1, 512, 64): "pgd", (2, 512, 64): None,
               (5, 1024, 32): "whitebox", (5, 512, 64): "whitebox"}
# ragged edges of the bf16 tensor-core kernel's tiles, checked untimed:
# styled_conv (n, h, w, cin, cout) -- partial M tiles of the wide and mid
# classes, a partial K chunk with Cout 96 in the small class; conv3x3
# (n, h, w, c) -- partial M tiles of the resident-weight class
STYLED_RAGGED = [(3, 70, 90, 128, 256), (4, 30, 20, 48, 192), (3, 3, 37, 48, 96)]
CONV_RAGGED = [(2, 37, 53, 64), (1, 33, 70, 32)]
# weight grad only, untimed: planes where the zero border and the partial
# tiles are a large share of the sum (a single pixel: 8 of 9 taps read only
# padding; a plane narrower than a k-step; one row and column past a tile)
WGRAD_RAGGED = [(1, 1, 1, 32), (1, 3, 37, 64), (2, 17, 16, 32), (3, 37, 53, 64)]
# the white-box batch, the legacy optimize's one image (phase 5d) and CW's
# batch of 8 (phase 5e)
ADAM_SHAPES = {(5, 1024, 1024, 3): "whitebox", (1, 1024, 1024, 3): "patch",
               (8, 1024, 1024, 3): "classifier", (3, 37, 53, 3): None}
# phase 5e's resnet PGD is timed; its ViT PGD (8 x 512^2) is checked untimed
PGD_SHAPES = {(2, 1024, 1024, 3): "pgd", (5, 1024, 1024, 3): "spatial",
              (8, 1024, 1024, 3): "classifier", (8, 512, 512, 3): None, (3, 37, 53, 3): None}
TOL = {"float32": 1e-3, "bfloat16": 3e-2}  # on max|err| / max(1, max|plain|)
# The weight grad returns float32 sums and rounds nothing to bf16. A product
# of two bf16 values is exact in float32, so the kernel and its plain version
# add the same exact terms and differ only by the order of the float32 sums
# (about 1e-5 of the largest entry at 5 x 1024^2 pixels). The shared bf16
# limit would pass a kernel that drops a halo row: one row of a 1024^2 plane
# is 1e-3 of the terms and moves the sum by far less than 3e-2.
KERNEL_TOL = {("conv3x3_wgrad", "bfloat16"): 1e-3}
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
               ops=0, path=None, core=None):
        tol = 0.0 if kernel in EXACT else KERNEL_TOL.get((kernel, dtype), TOL[dtype])
        ok = _within(err, rel, tol)
        b, by = bound_ms(nbytes, ops, dtype) if nbytes else (None, None)
        records.append(dict(kernel=kernel, case=case, dtype=dtype, max_abs_err=err,
                            rel_err=rel, tol=tol, ok=ok, ms=ms, plain_ms=plain,
                            library_ms=lib, conv_core_library_ms=core, bound_ms=b,
                            bound_by=by, path=path if ms is not None else None))
        log(f"  {kernel:14s} {case:22s} {dtype:8s} max_abs_err {err:.3e} "
            f"(rel {rel:.3e}, tol {tol:.0e}) {'ok' if ok else 'FAIL'}"
            + (f"  kernel {ms:.4f} ms plain {plain:.4f} ms bound {b:.4f} ms ({by})"
               if ms is not None else "")
            + (f" library {lib:.4f} ms" if lib is not None else "")
            + (f" conv core (cuDNN) {core:.4f} ms" if core is not None else ""))
        if not ok:
            failures.append(f"{kernel} {case} {dtype}: rel err {rel:.3e} > {tol}")

    def check_wgrad(x, g, case, timed, path):
        """The weight grad against its plain version; two launches on the
        same inputs must give the same bits (no atomics, a fixed order)."""
        n, h, wd, ch = x.shape
        dtype_name = str(x.dtype).removeprefix("torch.")
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        dw = c3.conv3x3_weight_grad_kernel(x, g)
        again = c3.conv3x3_weight_grad_kernel(x, g)
        torch.cuda.synchronize()
        if not torch.equal(dw, again):
            failures.append(f"conv3x3_wgrad {case} {dtype_name}: two launches on the same "
                            f"inputs differ by {(dw - again).abs().max().item():.3e}")
        err, rel = _err(torch, dw, c3.conv3x3_weight_grad_plain(x, g))
        record("conv3x3_wgrad", case, dtype_name, err, rel,
               *((time_ms(torch, lambda: c3.conv3x3_weight_grad_kernel(x, g)),
                  time_ms(torch, lambda: c3.conv3x3_weight_grad_plain(x, g)),
                  time_ms(torch, lambda: torch.nn.grad.conv2d_weight(
                      xn, (ch, ch, 3, 3), gn, padding=1)))
                 if timed else (None, None, None)),
               nbytes=2 * x.numel() * x.element_size() + 9 * ch * ch * 4,
               ops=2 * 9 * ch * ch * n * h * wd, path=path)

    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        isz = torch.tensor([], dtype=dt).element_size()
        # styled conv: the 9 synthesis shapes, at each path's batch, then
        # the ragged edges of the bf16 kernel's tiles (untimed)
        styled_cases = [(n, res, res, ch, ch, path) for n, path in STYLED_BATCHES.items()
                        for res, ch in STYLED_SHAPES]
        styled_cases += [(*shape, None) for shape in STYLED_RAGGED]
        for n, h, wd, cin, cout, path in styled_cases:
            x = rn(n, h, wd, cin, dtype=dt)
            w = rn(3, 3, cin, cout, dtype=torch.float32)
            s = rn(n, cin, dtype=torch.float32) * 0.5 + 1.0
            noise = rn(1, h, wd, 1, dtype=torch.float32)
            ns = torch.tensor(0.1, device=dev)
            b = rn(cout, dtype=torch.float32) * 0.1
            args = (x, w, s, noise, ns, b)
            y = sc.styled_conv_kernel(*args)
            torch.cuda.synchronize()
            err, rel = _err(torch, y, sc.styled_conv_plain(*args))
            timed = dtype_name == "bfloat16" and path is not None
            ms = time_ms(torch, lambda: sc.styled_conv_kernel(*args)) if timed else None
            plain = time_ms(torch, lambda: sc.styled_conv_plain(*args)) if timed else None
            case = f"n{n} {h}^2 c{cin}" if (h, cin) == (wd, cout) else \
                f"n{n} {h}x{wd} c{cin}->{cout}"
            record("styled_conv", case, dtype_name, err, rel, ms, plain,
                   nbytes=n * h * wd * (cin + cout) * isz + 9 * cin * cout * isz,
                   ops=2 * 9 * cin * cout * n * h * wd, path=path,
                   core=_conv_core_ms(torch, *args) if timed else None)
        # low-channel conv: forward, input grad, weight grad; then the
        # ragged edges (untimed)
        conv_cases = [(n, res, res, ch, path) for (n, res, ch), path in CONV_SHAPES.items()]
        conv_cases += [(*shape, None) for shape in CONV_RAGGED]
        for n, h, wd, ch, path in conv_cases:
            x = rn(n, h, wd, ch, dtype=dt)
            w = (rn(3, 3, ch, ch, dtype=torch.float32) / math.sqrt(9 * ch)).to(dt)
            g = rn(n, h, wd, ch, dtype=dt)
            timed = dtype_name == "bfloat16" and path is not None
            act = n * h * wd * ch * isz
            ops = 2 * 9 * ch * ch * n * h * wd
            case = f"n{n} {h}^2 c{ch}" if h == wd else f"n{n} {h}x{wd} c{ch}"
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

            check_wgrad(x, g, case, timed, path)
        for n, h, wd, ch in WGRAD_RAGGED:
            check_wgrad(rn(n, h, wd, ch, dtype=dt), rn(n, h, wd, ch, dtype=dt),
                        f"n{n} {h}x{wd} c{ch}", False, None)
        # PGD update: the main-path shape and an odd size
        for shape, path in PGD_SHAPES.items():
            adv = rn(*shape, dtype=dt).clamp(-1, 1)
            img = (adv.float() + 0.01 * rn(*shape, dtype=torch.float32)).clamp(-1, 1).to(dt)
            grd = rn(*shape, dtype=dt)
            args = (adv, grd, img, 0.02, 16 / 255, -1.0, 1.0)
            out = pu.pgd_update_kernel(*args)
            torch.cuda.synchronize()
            err, rel = _err(torch, out, pu.pgd_update_plain(*args))
            timed = dtype_name == "float32" and path is not None
            numel = adv.numel()
            record("pgd_update", "x".join(map(str, shape)), dtype_name, err, rel,
                   time_ms(torch, lambda: pu.pgd_update_kernel(*args)) if timed else None,
                   time_ms(torch, lambda: pu.pgd_update_plain(*args)) if timed else None,
                   nbytes=4 * numel * isz, ops=7 * numel, path=path)
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


def _conv_core_ms(torch, x, weight, style, *_):
    """The cuDNN yardstick for styled_conv's conv core: ``F.conv2d`` of the
    modulated input (bf16, channels-last) with the scaled weights, without
    the demodulation / noise / bias / activation epilogue, so it is kept
    apart from ``library_ms`` (timed only; the port never calls it)."""
    cin = x.shape[-1]
    xs = (x * style.to(x.dtype)[:, None, None, :]).permute(0, 3, 1, 2)
    wn = (weight / math.sqrt(9 * cin)).to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return time_ms(torch, lambda: torch.nn.functional.conv2d(xs, wn, padding=1))


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
    core = [r["conv_core_library_ms"] for r in timed]
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
        **({"conv_core_library_ms": sum(core)} if None not in core else {}),
        "shapes_timed": [f"{r['case']} {r['dtype']}" for r in timed],
    }


def summarize(records, runs):
    """One entry per kernel source: launches on the main paths and
    ``_numbers``. ``runs`` maps each main path ("pgd", "whitebox",
    "spatial", "patch") to its (launch counts, launches per step; per inner
    step on the patch path); ``launches`` is
    their sum. The numbers at the top of an entry are those of the kernel's
    home path (the fusion PGD path, or the white-box path for fused_adam);
    another path's shapes, where it has its own, are under its name (the
    spatial path's batch-1 synthesis shares the PGD path's shapes). conv3x3's entry
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
# phase 3b: the weight grad through the port's real call chain
# ---------------------------------------------------------------------------

# Both chains round the 3x3 conv's weight grad to bf16 once (the port's
# backward casts the kernel's float32 sums to the bf16 weight's dtype, cuDNN's
# weight grad returns bf16): 2^-8 = 3.9e-3 of an entry at most. The leaky-ReLU
# masks come from bf16 pre-activations that the two forwards round apart at a
# few pixels, which adds less. 1e-2 of max|plain grad|.
CHAIN_TOL = 1e-2


def check_weight_grad_chain(torch):
    """``styled_conv`` with ``weight.requires_grad`` at the two tail shapes:
    its backward recomputes the composite, whose 3x3 conv reaches
    ``conv3x3_weight_grad_kernel``; ``weight.grad`` is held against autograd
    through ``styled_conv_plain``, and one launch's device time is read by
    kernel. Then a full-width ``Generator`` of the
    script's own (the pipeline's stays frozen) runs forward and backward with
    its parameters requiring grad."""
    from tpufusion_torch.models.stylegan2 import Generator
    from tpufusion_torch.ops import conv3x3 as c3
    from tpufusion_torch.ops import styled_conv as sc

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(30)
    count = c3.conv3x3
    results = []

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for n, res, ch in ((1, 1024, 32), (5, 1024, 32), (1, 512, 64), (5, 512, 64)):
        x = rn(n, res, res, ch).bfloat16()
        weight = rn(3, 3, ch, ch)
        rest = (rn(n, ch) * 0.5 + 1.0, rn(1, res, res, 1), torch.tensor(0.1, device=dev),
                rn(ch) * 0.1)
        g = rn(n, res, res, ch).bfloat16()
        grads = []
        for fn in (sc.styled_conv, sc.styled_conv_plain):
            w = weight.clone().requires_grad_(True)
            before = count.launches_wgrad
            (dw,) = torch.autograd.grad(fn(x, w, *rest), w, g)
            torch.cuda.synchronize()
            grads.append((dw, count.launches_wgrad - before))
        (got, launched), (want, launched_plain) = grads
        err, _ = _err(torch, got, want)
        rel = err / want.abs().max().item()
        log(f"  styled_conv weight.grad n{n} {res}^2 c{ch} bf16: max_abs_err {err:.3e} "
            f"(rel {rel:.3e} of max|plain grad|, tol {CHAIN_TOL:.0e}); weight-grad launches "
            f"{launched} (plain chain {launched_plain})")
        if (launched, launched_plain) != (1, 0):
            fail(f"styled_conv backward at n{n} {res}^2 c{ch} launched the weight-grad kernel "
                 f"{launched} times (plain chain {launched_plain}), expected 1 (0)")
        if not _within(err, rel, CHAIN_TOL):
            fail(f"styled_conv weight.grad at n{n} {res}^2 c{ch} disagrees with autograd "
                 f"through styled_conv_plain: rel err {rel:.3e} > {CHAIN_TOL}")
        # one launch's device time, the second pass apart (the profiler is
        # first used in phase 6, after the main paths' step times are taken)
        parts = device_ms_by_group(torch, lambda: c3.conv3x3_weight_grad_kernel(x, g))
        log("    conv3x3_weight_grad_kernel device ms per launch (torch.profiler): "
            + (", ".join(f"{k} {v:.4f}" for k, v in sorted(parts.items())) or "not measured"))
        results.append(dict(case=f"n{n} {res}^2 c{ch}", max_abs_err=err, rel_err=rel,
                            tol=CHAIN_TOL, wgrad_launches=launched, wgrad_device_ms=parts))

    model = Generator(size=1024, channel_multiplier=2, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(31))
    z = torch.randn((1, model.style_dim), generator=gen, device=dev).to(
        model.policy.compute_dtype)
    before = count.launches_wgrad
    image = model([z]).image
    image.backward(torch.randn(image.shape, generator=gen, device=dev))
    torch.cuda.synchronize()
    launched = count.launches_wgrad - before
    params = list(model.named_parameters())
    bad = [name for name, p in params if p.grad is None or not torch.isfinite(p.grad).all()]
    log(f"  full-width Generator (1024^2, batch 1) forward + backward: weight-grad launches "
        f"{launched}, {len(params) - len(bad)} of {len(params)} parameter grads finite")
    if launched != 2:
        fail(f"the generator's backward launched the weight-grad kernel {launched} times, "
             f"expected 2 (the 512^2 c64 and 1024^2 c32 styled convs)")
    if tuple(image.shape) != (1, 1024, 1024, 3) or bad:
        fail(f"generator backward: image {tuple(image.shape)}, parameters without a finite "
             f"grad: {bad[:8]}")
    return dict(styled_conv=results, generator_wgrad_launches=launched,
                generator_parameters=len(params))


# ---------------------------------------------------------------------------
# phase 4: small-input reference (card through the kernels vs CPU plain)
# ---------------------------------------------------------------------------

SMALL_PIPELINE = dict(size=32, channel_multiplier=1, encoder_base_channels=16,
                      encoder_units=(1, 1, 1, 1), encoder_input_size=32,
                      mean_latent_samples=64, seed=3)
SMALL_WB_LR, SMALL_WB_ITERS = 1e-2, 3
SMALL_INPUT_SEED = 9
SMALL_SPATIAL_SEED = 10  # the 5 spatial inputs: a generator of their own
WITNESS_STEP, WITNESS_DRAWS = 1e-6, 4  # the float64 witness's input moves


def small_inputs(torch, seed=SMALL_INPUT_SEED):
    """Phase 4's two 32^2 inputs and its target, drawn on the CPU. The
    white-box check holds at any seed (``hold_to_witness``); at seed 9 no
    pixel needs more than the flat 0.2 lr, at seed 4 a few do
    (tests/test_torch_phase4_witness.py)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1
    t = torch.rand((1, 32, 32, 3), generator=gen) * 2 - 1
    return x, t


@contextlib.contextmanager
def _float64_casts(torch):
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


def whitebox_witness(torch, cpu, x, t, cfg, step=WITNESS_STEP, draws=WITNESS_DRAWS):
    """The white-box attack of ``cfg`` on the CPU in float64 (the weights of
    the float32 pipeline ``cpu`` widened, every cast to float32 in the port
    made a cast to float64), from ``x`` and from ``x`` moved by ``step`` in
    ``draws`` seeded random directions. Returns the float64 pixel moves from
    ``x`` and, per pixel, the largest change of that move under the input
    moves: where it is large, rounding alone decides the pixel's Adam steps,
    and a float32 run may land that far away."""
    from tpufusion_torch.attacks.whitebox import run_whitebox
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.pipeline import FusionPipeline

    wide = FusionPipeline.create("ffhq", device="cpu", policy=Policy(torch.float64),
                                 **SMALL_PIPELINE)
    for name in ("generator", "encoder", "vgg"):
        getattr(wide, name).load_state_dict(getattr(cpu, name).state_dict())
        getattr(wide, name).double()
    wide.latent_avg = cpu.latent_avg.double()
    gen = torch.Generator().manual_seed(9)
    starts = [x.double()] + [
        x.double() + step * torch.randn(x.shape, generator=gen, dtype=torch.float64)
        for _ in range(draws)]
    with _float64_casts(torch):
        moves = [run_whitebox(wide, s, t.double(), cfg)[0] - s for s in starts]
    if moves[0].dtype != torch.float64:
        fail("the float64 witness ran in " + str(moves[0].dtype))
    change = torch.stack([(m - moves[0]).abs() for m in moves[1:]]).amax(dim=0)
    return moves[0], change


def hold_to_witness(adv, x, base, change, mask, lr):
    """A float32 run's adversarial images ``adv`` against the float64 run:
    each masked pixel's move within 0.2 lr plus that pixel's own float64
    change of the witness's move ``base``. The flat part is the limit as it
    was; the margin widens only at pixels whose float64 run is itself
    unstable. Returns the worst excess over the margin (<= 0 passes), the
    worst difference, the mean difference and the number of pixels that
    needed more than the flat 0.2 lr."""
    d = ((adv.double().cpu() - x.double()) - base).abs()[mask]
    margin = 0.2 * lr + change[mask]
    return dict(excess=(d - margin).max().item(), worst=d.max().item(),
                mean=d.mean().item(), needed_margin=int((d > 0.2 * lr).sum()),
                pixels=int(mask.sum()))


def small_spatial_inputs(torch):
    """Phase 4's five 32^2 spatial inputs (the ffhq roles) and a target."""
    gen = torch.Generator().manual_seed(SMALL_SPATIAL_SEED)
    x = torch.rand((5, 32, 32, 3), generator=gen) * 2 - 1
    t = torch.rand((1, 32, 32, 3), generator=gen) * 2 - 1
    return x, t


def check_fusion_card_vs_cpu(torch, cpu, gpu, x, t, mode):
    """The fused image (2e-3) and the pixel and 'vgg' objectives' input
    gradients (1e-2 of the largest entry) of fusion ``mode``, card against
    CPU."""
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, make_fused_image_fn, make_fusion_loss)

    label = "" if mode == "arithmetic" else f"{mode} "
    with torch.no_grad():
        f_cpu = make_fused_image_fn(cpu, mode)(x)
        f_gpu = make_fused_image_fn(gpu, mode)(x.cuda()).cpu()
    err = (f_cpu - f_gpu).abs().max().item()
    log(f"  small reference: {label}fused 32^2 card vs CPU max_abs_err {err:.3e} (tol 2e-3)")
    if not (math.isfinite(err) and err <= 2e-3):
        fail(f"32^2 {label}fused image on the card disagrees with the CPU: {err}")
    for objective in ("pixel", "vgg"):
        grads = []
        for p, dev in ((cpu, "cpu"), (gpu, "cuda")):
            loss_fn = make_fusion_loss(p, FusionAttackConfig(mode=mode, objective=objective))
            xa = x.to(dev).requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(xa, t.to(dev)), xa)
            grads.append(g.cpu())
        rel = ((grads[0] - grads[1]).abs().max() / grads[0].abs().max()).item()
        log(f"  small reference: {label}'{objective}' loss grad card vs CPU rel err {rel:.3e} "
            f"(tol 1e-2)")
        if not (math.isfinite(rel) and rel <= 1e-2):
            fail(f"32^2 {label}'{objective}' attack gradient on the card disagrees with the "
                 f"CPU: {rel}")


def check_small_reference(torch):
    from tpufusion_torch.attacks.whitebox import (
        PRESET_ATTACK_MAIN, WhiteboxConfig, _make_loss, _make_ref, run_whitebox)
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.pipeline import FusionPipeline

    torch.backends.cudnn.allow_tf32 = False
    cpu = FusionPipeline.create("ffhq", device="cpu", policy=Policy(), **SMALL_PIPELINE)
    gpu = FusionPipeline.create("ffhq", device="cuda", policy=Policy(), **SMALL_PIPELINE)
    for name in ("generator", "encoder", "vgg"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    gpu.drawer.blender.load_state_dict(cpu.drawer.blender.state_dict())
    gpu.latent_avg = cpu.latent_avg.cuda()
    x, t = small_inputs(torch)
    check_fusion_card_vs_cpu(torch, cpu, gpu, x, t, "arithmetic")

    # the white-box attack, 3 iterations: the total trace to 1e-5 relative
    # (an H100 run read 5.95e-07, PERF.md);
    # adv where the first step's |g| > 1e-6 (Adam's first step is
    # lr * g / (|g| + eps): where the gradient vanishes, float noise moves a
    # pixel by up to lr). From the second step Adam divides by each pixel's
    # own gradient history and amplifies the leaky-ReLU-kink differences of
    # the two devices' gradients (tests/test_torch_whitebox.py), so the mean
    # is held to 1e-5 and each pixel, on the card and on the CPU alike, to
    # 0.2 lr of a float64 CPU run plus that pixel's own float64 change when
    # the inputs move by 1e-6: at a pixel whose third Adam step flips under
    # such a move, float32 rounding alone decides where a run lands.
    lr = SMALL_WB_LR
    cfg = WhiteboxConfig(lr=lr, n_iters=SMALL_WB_ITERS)
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
        f"max err {d.max().item():.3e}, mean {d.mean().item():.3e} (tol 1e-5)")
    if not (math.isfinite(rel) and rel <= 1e-5):
        fail(f"32^2 white-box trace on the card disagrees with the CPU: {rel}")
    if not d.mean().item() <= 1e-5:
        fail(f"32^2 white-box adv on the card disagrees with the CPU: mean {d.mean().item()}")
    base, change = whitebox_witness(torch, cpu, x, t, cfg)
    for name, out in zip(("CPU float32", "card"), outs):
        held = hold_to_witness(out[0], x, base, change, mask, lr)
        log(f"  small reference: white-box adv, {name} vs float64 CPU: max err "
            f"{held['worst']:.3e}, mean {held['mean']:.3e}; {held['needed_margin']} of "
            f"{held['pixels']} pixels needed more than {0.2 * lr:.0e} (largest float64 "
            f"change under {WITNESS_DRAWS} input moves of {WITNESS_STEP:.0e}: "
            f"{change[mask].max().item():.3e}); worst excess over the margin "
            f"{held['excess']:.3e}")
        if not held["excess"] <= 0:
            fail(f"32^2 white-box adv ({name}) leaves the float64 run's margin by "
                 f"{held['excess']}")
    check_fusion_card_vs_cpu(torch, cpu, gpu, *small_spatial_inputs(torch), "spatial")
    check_patch_lpips_legacy(torch, cpu, gpu, x, t)
    check_classifier_small(torch, gpu)
    torch.backends.cudnn.allow_tf32 = True


SMALL_PATCH_DRAW = (1, (5, 7))  # one quarter turn, top-left corner (5, 7)
SMALL_LEGACY_ITERS = 2
# the patch step with the reconstruction terms on: the decoder and the VGG
# taps of the reconstruction enter the loss (styled_conv and conv3x3 on the
# card)
PATCH_REC_WEIGHTS = dict(w_img_rec_target=1.0, w_lpips_rec_target=1.0)


def _rel(torch, got, want):
    """max|got - want| over max(1, max|want|), both on the CPU; inf when
    ``got`` is not finite."""
    return _err(torch, got.cpu(), want)[1]


def check_patch_lpips_legacy(torch, cpu, gpu, x, t):
    """Phase 4's patch, LPIPS and legacy-optimize checks, card against CPU
    in float32 with the same weights. Limits, as for the fused image and the
    gradients above: a forward (loss traces, the LPIPS distance) to 2e-3 of
    max(1, max|cpu|); the patch's move after 2 raw gradient steps, which is
    the sum of 2 gradients, to 1e-2 of its largest entry. The legacy run's
    pixels after 2 Adam steps: their mean difference to 1e-5 and each to 0.2
    lr where the first step's |g| > 1e-6, as the white-box run's (Adam's
    first step is lr * sign(g) there; the second divides by each pixel's own
    gradient history)."""
    from tpufusion_torch.attacks.patch import (
        PatchConfig, init_patch_square, make_patch_attack_step)
    from tpufusion_torch.attacks.whitebox import LegacyOptimizeConfig, make_legacy_optimize
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.models.lpips import LPIPS

    img = x[:1]
    patch0 = init_patch_square(32, 0.1, torch.Generator().manual_seed(11))
    for label, weights in (("default weights", {}), ("reconstruction terms", PATCH_REC_WEIGHTS)):
        cfg = PatchConfig(max_count=2, **weights)
        (p_cpu, tr_cpu), (p_gpu, tr_gpu) = (
            make_patch_attack_step(p, cfg, t.to(dev))(img.to(dev), patch0.to(dev),
                                                      draw=SMALL_PATCH_DRAW)
            for p, dev in ((cpu, "cpu"), (gpu, "cuda")))
        rel_tr = _rel(torch, tr_gpu, tr_cpu)
        move_cpu, move_gpu = p_cpu - patch0, p_gpu.cpu() - patch0
        rel_mv = ((move_gpu - move_cpu).abs().max() / move_cpu.abs().max()).item()
        log(f"  small reference: patch step ({label}, max_count 2) card vs CPU: loss trace "
            f"rel err {rel_tr:.3e} (tol 2e-3), patch move rel err {rel_mv:.3e} (tol 1e-2)")
        if not (_within(rel_tr, rel_tr, 2e-3) and _within(rel_mv, rel_mv, 1e-2)):
            fail(f"32^2 patch step ({label}) on the card disagrees with the CPU: trace "
                 f"{rel_tr}, move {rel_mv}")

    lp_cpu = LPIPS(device="cpu", policy=Policy(), generator=torch.Generator().manual_seed(12))
    lp_gpu = LPIPS(device="cuda", policy=Policy())
    lp_gpu.load_state_dict(lp_cpu.state_dict())
    with torch.no_grad():
        rel = _rel(torch, lp_gpu(x.cuda(), t.cuda()), lp_cpu(x, t))
    log(f"  small reference: LPIPS distance card vs CPU rel err {rel:.3e} (tol 2e-3)")
    if not _within(rel, rel, 2e-3):
        fail(f"32^2 LPIPS distance on the card disagrees with the CPU: {rel}")

    lr = SMALL_WB_LR
    for variant in ("optimize", "optimize_copy"):
        cfg = LegacyOptimizeConfig(lr=lr, n_iters=SMALL_LEGACY_ITERS, variant=variant,
                                   snapshot_every=0)
        (a_cpu, tr_cpu, _), (a_gpu, tr_gpu, _) = (
            make_legacy_optimize(p, lp, cfg)(img.to(dev), t.to(dev))
            for p, lp, dev in ((cpu, lp_cpu, "cpu"), (gpu, lp_gpu, "cuda")))
        rel = _rel(torch, tr_gpu["total"], tr_cpu["total"])
        g = _legacy_first_grad(torch, cpu, lp_cpu, variant, img, t)
        d = (a_gpu.cpu() - a_cpu).abs()[g.abs() > 1e-6]
        log(f"  small reference: legacy {variant}, {SMALL_LEGACY_ITERS} iters, card vs CPU: "
            f"total trace rel err {rel:.3e} (tol 2e-3); pixels where |g| > 1e-6 max err "
            f"{d.max().item():.3e} (tol {0.2 * lr:.0e}), mean {d.mean().item():.3e} (tol 1e-5)")
        if not (_within(rel, rel, 2e-3) and d.max().item() <= 0.2 * lr
                and d.mean().item() <= 1e-5):
            fail(f"32^2 legacy {variant} on the card disagrees with the CPU: trace {rel}, "
                 f"pixels max {d.max().item()}, mean {d.mean().item()}")


def _legacy_first_grad(torch, pipe, lp, variant, img, t):
    """The legacy loss's input gradient at the first step (x = img)."""
    from tpufusion_torch.attacks.whitebox import _make_legacy_loss

    ref_fn, loss_fn = _make_legacy_loss(pipe, lp, variant)
    x = img.clone().requires_grad_(True)
    total, _ = loss_fn(x, ref_fn(img, t))
    return torch.autograd.grad(total, x)[0]


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

# the full-width FFHQ pipeline of phases 5-6: config-f generator, e4e
# IR-SE-50, seeded random weights
FULL_PIPELINE = dict(size=1024, channel_multiplier=2, encoder_base_channels=64,
                     encoder_units=(3, 4, 14, 3), encoder_input_size=256, seed=0)


def run_main_path(torch, card):
    from tpufusion_torch import ops
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, fgsm_on_fusion, make_fused_image_fn, make_fusion_attack,
        make_fusion_loss)
    from tpufusion_torch.pipeline import FusionPipeline

    t0 = time.perf_counter()
    pipe = FusionPipeline.create("ffhq", device="cuda", **FULL_PIPELINE)
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


# ---------------------------------------------------------------------------
# phase 5c: the spatial-fusion main path at full width
# ---------------------------------------------------------------------------

SPATIAL_N, SPATIAL_STEPS = 5, 5  # the ffhq roles; BASELINE config 3
FUSION_MODES = ("spatial", "arithmetic")
PARTIAL_TOL = 3e-2  # batch 6 against batch 1 in bf16, of max(1, max|ref|)
# the fewest launches of each kernel in one spatial PGD step: the fused
# synthesis's 9 styled convs, the 32/64-channel convs of its backward, the
# pixel update
SPATIAL_STEP_MIN = {"styled_conv": 9, "conv3x3_fwd": 2, "conv3x3_dgrad": 2, "pgd_update": 1}


def spatial_launch_failures(per_step, fwd_launches, eval_launches, n_fwd):
    """What phase 5c's launch counts fall short of: per PGD step at least
    ``SPATIAL_STEP_MIN``; exactly 9 styled convs per fused forward; exactly
    one batch-6 synthesis (9 styled convs) per mode in a round of partial
    fusions."""
    out = [f"a spatial PGD step launched {k} {per_step[k]} times, expected >= {n}"
           for k, n in SPATIAL_STEP_MIN.items() if per_step[k] < n]
    if fwd_launches != 9 * n_fwd:
        out.append(f"{n_fwd} spatial fused forwards launched styled_conv {fwd_launches} "
                   f"times, expected {9 * n_fwd}")
    if eval_launches != 9 * len(FUSION_MODES):
        out.append(f"the partial fusions launched styled_conv {eval_launches} times, "
                   f"expected {9 * len(FUSION_MODES)}")
    return out


def run_spatial_path(torch, card, pipe):
    """The spatial-fusion PGD attack with the VGG objective on N = 5 1024^2
    inputs (the ffhq roles) and one target: a warm-up forward and step, then
    with the launch counts set to 0: three timed no-grad fused forwards,
    FGSM and 5 PGD steps at the default eps and alpha, then the evaluation
    of the attack: the benign fusions and the partial fusions of both modes
    with their metrics (``partial_eval_ms``: both modes' partial fusions and
    metrics, after one untimed round). The counts are read at the end."""
    from tpufusion_torch import ops
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, fgsm_on_fusion, make_fused_image_fn, make_fusion_attack,
        make_fusion_loss)
    from tpufusion_torch.eval import benign_fusion, fused_image_metrics, partial_adv_fusion
    from tpufusion_torch.fusion.spatial import spatial_fusion

    gen = torch.Generator(device="cuda").manual_seed(2)
    inputs = torch.rand((SPATIAL_N, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    target = torch.rand((1, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    fused_fn = make_fused_image_fn(pipe, "spatial")
    cfg = FusionAttackConfig(mode="spatial", objective="vgg")
    pgd_cfg = dataclasses.replace(cfg, pgd=dataclasses.replace(cfg.pgd, steps=SPATIAL_STEPS))
    eps = cfg.pgd.eps

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
    adv1, tr1 = fgsm_on_fusion(pipe, mode="spatial", objective="vgg")(inputs, target)
    before_pgd = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adv, trace = make_fusion_attack(pipe, pgd_cfg)(inputs, target, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / SPATIAL_STEPS
    after_pgd = ops.launch_counts()
    per_step = {k: (after_pgd[k] - before_pgd[k]) / SPATIAL_STEPS for k in after_pgd}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    with torch.no_grad():
        final_loss = make_fusion_loss(pipe, cfg)(adv, target).item()
        clean, adv_latents = pipe.get_latents(inputs), pipe.get_latents(adv)
        benign = {m: benign_fusion(pipe.drawer, clean, m) for m in FUSION_MODES}

        def evaluate():
            out = {}
            for m in FUSION_MODES:
                part = partial_adv_fusion(pipe.drawer, clean, adv_latents, m)
                out[m] = (part, fused_image_metrics(pipe, benign[m][0], part))
            return out

        before_eval = ops.launch_counts()["styled_conv"]
        evaluate()
        eval_launches = ops.launch_counts()["styled_conv"] - before_eval
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluated = evaluate()
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        ref = spatial_fusion(pipe.drawer, adv_latents)[0]
    launches = ops.launch_counts()

    if tuple(fused.shape) != (1, 1024, 1024, 3) or not torch.isfinite(fused).all():
        fail(f"spatial fused image has shape {tuple(fused.shape)} or non-finite values")
    trace = trace.float().cpu().tolist()
    for name, a in (("spatial fgsm", adv1), ("spatial pgd", adv)):
        dev_max = (a - inputs).abs().max().item()
        if not torch.isfinite(a).all() or dev_max > eps + 1e-6:
            fail(f"{name}: adv leaves the eps-ball ({dev_max} > {eps})")
    if not all(math.isfinite(v) for v in trace + [final_loss, tr1.item()]):
        fail(f"spatial: non-finite loss: {trace}, {final_loss}")
    if not final_loss < trace[0]:
        fail(f"spatial loss did not descend: {trace[0]} -> {final_loss}")
    short = spatial_launch_failures(per_step, fwd_launches, eval_launches, n_fwd)
    if short:
        fail("; ".join(short))
    metrics = {}
    for m, (part, (mse, vgg, ssim)) in evaluated.items():
        fz, singles, feats = benign[m]
        if tuple(part.shape) != (SPATIAL_N + 1, 1024, 1024, 3):
            fail(f"{m} partial fusion has shape {tuple(part.shape)}")
        for name, v in (("fused", fz), ("singles", singles), ("features", feats),
                        ("partial", part), ("mse", mse), ("vgg", vgg), ("ssim", ssim)):
            if not torch.isfinite(v).all():
                fail(f"{m} evaluation: non-finite {name}")
        if not bool(((ssim >= -1) & (ssim <= 1)).all()):
            fail(f"{m} SSIM outside [-1, 1]: {ssim.tolist()}")
        metrics[m] = dict(mse=mse.tolist(), vgg=vgg.tolist(), ssim=ssim.tolist())
    err, rel = _err(torch, evaluated["spatial"][0][-1:], ref)
    if not _within(err, rel, PARTIAL_TOL):
        fail(f"the all-adversarial spatial partial (batch 6) disagrees with spatial_fusion "
             f"at batch 1: rel err {rel:.3e} > {PARTIAL_TOL}")
    log(f"  spatial_fused_forward_ms {fwd_ms:.3f} [{card}] (mean of {n_fwd})")
    log(f"  spatial_pgd_step_ms {step_ms:.3f} [{card}] (N={SPATIAL_N} inputs, 1024^2, bf16, "
        f"'vgg' objective, {SPATIAL_STEPS} steps)")
    log(f"  spatial_peak_memory_gib {peak_gib:.3f} [{card}]")
    log(f"  partial_eval_ms {eval_ms:.3f} [{card}] (partial fusions, batch {SPATIAL_N + 1}, "
        f"and their metrics, both modes)")
    log(f"  loss trace {trace} -> final {final_loss:.6f}; fgsm loss {tr1.item():.6f}")
    log(f"  all-adversarial spatial partial vs spatial_fusion at batch 1: max_abs_err "
        f"{err:.3e} (rel {rel:.3e}, tol {PARTIAL_TOL:.0e})")
    for m, v in metrics.items():
        log(f"  {m} partial metrics: mse {v['mse']}, vgg {v['vgg']}, ssim {v['ssim']}")
    log(f"  launches {launches} ({n_fwd} fused forwards: styled_conv {fwd_launches}; per PGD "
        f"step {per_step}; partial fusions, one round: styled_conv {eval_launches})")
    return launches, per_step, dict(
        spatial_fused_forward_ms=fwd_ms, spatial_pgd_step_ms=step_ms,
        spatial_peak_memory_gib=peak_gib, partial_eval_ms=eval_ms, spatial_loss_trace=trace,
        spatial_final_loss=final_loss, partial_metrics=metrics,
        spatial_partial_vs_batch1=rel), (cfg, inputs, target, gen)


# ---------------------------------------------------------------------------
# phase 5d: patch training, the baselines, the hybrid splice and the legacy
# optimize at full width
# ---------------------------------------------------------------------------

PATCH_N = 5  # fusion inputs, the ffhq roles
PATCH_IMAGES, PATCH_COUNT = 2, 5  # of the reference's 2000 images x 50 inner steps
CIRCLE_COUNT = 2
PASTE_TIMES = 3  # the runner's --paste_times
BASELINE_SCALE = 0.4  # the runner's --scale: the blur's k and dp_noise's scale
WBP_ITERS = 3  # white_box_patch iterations, lr 1e-4 (configs/ffhq_whitebox.json)
LEGACY_ITERS, LEGACY_EVERY = 3, 2
DP_MEAN_TOL = 0.02  # mean |noise| within 2% of the scale (E|Laplace(b)| = b)
PATCH_PATH_KERNELS = ("styled_conv", "conv3x3_fwd", "conv3x3_dgrad", "fused_adam")


def _fuse_ok(torch, fused, n=1):
    return tuple(fused.shape) == (n, 1024, 1024, 3) and bool(torch.isfinite(fused).all())


def patch_launch_failures(launches):
    """What phase 5d's launch counts fall short of: styled_conv, the conv3x3
    forward and input grad and fused_adam launched, the weight grad not
    (the weights are frozen)."""
    out = [f"phase 5d launched {k} no time" for k in PATCH_PATH_KERNELS if launches[k] <= 0]
    if launches["conv3x3_wgrad"] != 0:
        out.append(f"phase 5d launched the weight grad {launches['conv3x3_wgrad']} times, "
                   f"expected 0")
    return out


def _check_patch_batch(torch, what, img, patch, trace, descent):
    """The patch after a batch lies in the batch image's [min, max]; with
    ``descent`` the batch's loss fell from its first inner step to its
    last."""
    lo, hi = img.min().item(), img.max().item()
    trace = trace.float().cpu()
    if not torch.isfinite(trace).all() or (descent and not trace[-1] < trace[0]):
        fail(f"{what}: the loss did not fall over {PATCH_COUNT} inner steps: {trace.tolist()}")
    if not (patch.min().item() >= lo and patch.max().item() <= hi):
        fail(f"{what}: the patch [{patch.min().item()}, {patch.max().item()}] leaves the "
             f"image's range [{lo}, {hi}]")


def _float32_patch_descent(torch, pipe, cfg, train, patch0, draws):
    """The square patch batches of phase 5d (a) again, with a float32 copy
    of the full-width encoder and TF32 off: each batch's loss must fall.
    Returns the loss traces."""
    from tpufusion_torch.attacks.patch import make_patch_attack_step
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.models.e4e import Encoder4Editing

    enc = Encoder4Editing(pipe.generator.n_latent,
                          base_channels=FULL_PIPELINE["encoder_base_channels"],
                          unit_counts=FULL_PIPELINE["encoder_units"],
                          input_size=pipe.encoder_input_size, policy=Policy(), device="cuda")
    enc.load_state_dict(pipe.encoder.state_dict())
    enc.requires_grad_(False)
    step = make_patch_attack_step(dataclasses.replace(pipe, encoder=enc, policy=Policy()), cfg)
    torch.backends.cudnn.allow_tf32 = False
    patch, traces = patch0, []
    for i, draw in enumerate(draws):
        img = train[i : i + 1]
        patch, trace = step(img, patch, draw=draw)
        traces.append(trace.float().cpu().tolist())
        _check_patch_batch(torch, f"patch batch {i} (float32)", img, patch, trace, descent=True)
    torch.backends.cudnn.allow_tf32 = True
    return traces


def run_patch_path(torch, card, pipe):
    """Phase 5d on the pipeline of phase 5 (the launch counts set to 0 just
    before, read just after): (a) square patch training, 2 images x 5 inner
    steps, then a circle patch, 1 image x 2; (b) the trained square patch on
    5 inputs, their arithmetic and spatial fusions and the partial fusions
    of both modes; (c) ``white_box_patch``: ``run_whitebox`` toward the
    per-image paste targets; (d) the baselines, each fused arithmetically;
    (e) the hybrid splice of the blur and dp batches; (f) both legacy
    variants on one image. Returns the launch counts, the launches per patch
    inner step, the numbers and a patch batch for phase 6d."""
    from tpufusion_torch import ops
    from tpufusion_torch.attacks import (
        PRESET_ATTACK_MAIN, LegacyOptimizeConfig, PatchConfig, WhiteboxConfig, apply_patch,
        canonical_canvas, dp_noise, gaussian_blur_noise, init_patch_square,
        make_fused_image_fn, make_legacy_optimize, make_patch_attack_step, out_domain_more,
        out_domain_single, paste_patch, run_whitebox, splice_hybrid, train_patch)
    from tpufusion_torch.core.imaging import resize_bilinear
    from tpufusion_torch.eval import benign_fusion, partial_adv_fusion
    from tpufusion_torch.models.lpips import LPIPS
    from tpufusion_torch.ops.adam_update import B1, B2

    size = pipe.image_size
    gen = torch.Generator(device="cuda").manual_seed(6)
    inputs = torch.rand((PATCH_N, size, size, 3), generator=gen, device="cuda") * 2 - 1
    target = torch.rand((1, size, size, 3), generator=gen, device="cuda") * 2 - 1
    train = torch.rand((PATCH_IMAGES, size, size, 3), generator=gen, device="cuda") * 2 - 1
    fused_fn = make_fused_image_fn(pipe)
    cfg = PatchConfig(patch_type="square", patch_frac=0.1, max_count=PATCH_COUNT)
    step = make_patch_attack_step(pipe, cfg)
    # warm-up: one inner step (cuDNN plans of the encoder's backward)
    make_patch_attack_step(pipe, dataclasses.replace(cfg, max_count=1))(
        train[:1], init_patch_square(size, cfg.patch_frac, gen), gen)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    out = {}

    # (a) square patch training: train_patch's loop, with the patch read
    # after each batch; the placements are drawn first, so that the float32
    # run below trains on the same batches
    patch0 = init_patch_square(size, cfg.patch_frac, gen)
    side = patch0.shape[0]
    draws = [(int(torch.randint(0, 4, (), generator=gen, device="cuda")),
              tuple(torch.randint(0, size - side + 1, (2,), generator=gen,
                                  device="cuda").tolist())) for _ in range(PATCH_IMAGES)]
    inner_ms, traces = [], []
    torch.cuda.reset_peak_memory_stats()
    patch = patch0
    for i in range(PATCH_IMAGES):
        img = train[i : i + 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        patch, trace = step(img, patch, draw=draws[i])
        torch.cuda.synchronize()
        inner_ms.append((time.perf_counter() - t0) * 1e3 / PATCH_COUNT)
        traces.append(trace.float().cpu().tolist())
        _check_patch_batch(torch, f"patch batch {i} (bf16)", img, patch, trace, descent=False)
    patch_counts = ops.launch_counts()
    per_inner = {k: v / (PATCH_IMAGES * PATCH_COUNT) for k, v in patch_counts.items()}
    out.update(patch_inner_step_ms=statistics.median(inner_ms),
               patch_inner_step_ms_per_batch=inner_ms, patch_loss_traces=traces,
               patch_peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               patch_side=side)
    log(f"  patch_inner_step_ms {out['patch_inner_step_ms']:.3f} [{card}] (square {side}^2, "
        f"1024^2, bf16, median over {PATCH_IMAGES} batches of {PATCH_COUNT} inner steps after "
        f"a warm-up step; per batch {[round(v, 3) for v in inner_ms]})")
    log(f"  patch_peak_memory_gib {out['patch_peak_memory_gib']:.3f} [{card}]")
    log(f"  bf16 patch loss traces {traces} (patch within each image's range)")
    # The reference's raw step (patch -= grad) moves a pixel by ~1e-6 here,
    # and the loss by ~3e-7 a step: below bf16's rounding of the encoder's
    # input, so the bf16 traces above move by rounding. The descent is held
    # on the same batches with the encoder in float32 (TF32 off).
    traces32 = _float32_patch_descent(torch, pipe, cfg, train, patch0, draws)
    out["patch_loss_traces_float32"] = traces32
    log(f"  float32 patch loss traces {traces32} (each falls; patch within each image's range)")
    circle_cfg = dataclasses.replace(cfg, patch_type="circle", max_count=CIRCLE_COUNT)
    c_canvas, c_mask = train_patch(pipe, [train[:1]], gen, circle_cfg)
    c_side = int(c_mask[:, :, 0].any(dim=0).sum().item())
    outside = c_mask == 0
    if not (bool((c_canvas[outside] == 0).all()) and set(c_mask.unique().tolist()) <= {0.0, 1.0}
            and bool(torch.isfinite(c_canvas).all())):
        fail("circle patch: canvas non-zero outside its mask, or a mask that is not binary")
    log(f"  circle patch (bounding square {c_side}^2, {CIRCLE_COUNT} inner steps): mask "
        f"{int(c_mask[:, :, 0].sum().item())} pixels, canvas zero outside it")

    # (b) the trained square patch on the fusion inputs
    canvas, mask = canonical_canvas(patch, size, "square")
    patched = apply_patch(inputs, canvas, mask)
    off = (mask == 0).expand_as(patched)
    if not torch.equal(patched[off], inputs[off]):
        fail("apply_patch changed pixels outside the mask")
    with torch.no_grad():
        clean, adv_lat = pipe.get_latents(inputs), pipe.get_latents(patched)
        for mode in ("arithmetic", "spatial"):
            fz = make_fused_image_fn(pipe, mode)(patched)
            part = partial_adv_fusion(pipe.drawer, clean, adv_lat, mode)
            benign = benign_fusion(pipe.drawer, clean, mode)[0]
            if not (_fuse_ok(torch, fz) and _fuse_ok(torch, part, PATCH_N + 1)
                    and _fuse_ok(torch, benign)):
                fail(f"patched inputs: a {mode} fusion is non-finite or misshapen")
    log(f"  apply_patch: pixels outside the mask bit-identical; arithmetic and spatial fusions "
        f"and partial fusions (batch {PATCH_N + 1}) of the patched inputs finite")

    # (c) white_box_patch: per-image paste targets into run_whitebox
    wcfg = WhiteboxConfig(lr=WB_LR, n_iters=WBP_ITERS, weights=PRESET_ATTACK_MAIN)
    targets = paste_patch(inputs, target, PASTE_TIMES)
    adam_before = ops.launch_counts()["fused_adam"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adv, trace = run_whitebox(pipe, inputs, targets, wcfg)
    torch.cuda.synchronize()
    out["whitebox_patch_step_ms"] = (time.perf_counter() - t0) * 1e3 / WBP_ITERS
    out["whitebox_patch_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    adam_launches = ops.launch_counts()["fused_adam"] - adam_before
    totals = trace["total"].float().cpu()
    moved = (adv - inputs).abs().max().item()
    adam_bound = WBP_ITERS * WB_LR * (1 - B1) / math.sqrt(1 - B2)
    if not bool((totals[:, -1] < totals[:, 0]).all()):
        fail(f"white_box_patch total did not fall for every image: {totals.tolist()}")
    if not (torch.isfinite(adv).all() and 0 < moved <= adam_bound + 1e-6):
        fail(f"white_box_patch pixels moved {moved}, expected in (0, {adam_bound}]")
    if adam_launches != WBP_ITERS:
        fail(f"{WBP_ITERS} white_box_patch iterations launched fused_adam {adam_launches} times")
    out["whitebox_patch_total_trace"] = totals.tolist()
    log(f"  whitebox_patch_step_ms {out['whitebox_patch_step_ms']:.3f} [{card}] (N={PATCH_N}, "
        f"paste targets x{PASTE_TIMES}, {WBP_ITERS} iterations, lr {WB_LR})")
    log(f"  whitebox_patch_peak_memory_gib {out['whitebox_patch_peak_memory_gib']:.3f} [{card}]")
    log(f"  white_box_patch totals {totals.tolist()} fall for every image; pixels moved at most "
        f"{moved:.6e} (Adam bound {adam_bound:.6e}); fused_adam launches {adam_launches}")

    # (d) the baselines, each fused arithmetically
    k = max(int(BASELINE_SCALE * size) | 1, 3)  # the runner's odd kernel
    gaussian_blur_noise(inputs, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blurred = gaussian_blur_noise(inputs, k)
    torch.cuda.synchronize()
    out["blur_ms"] = (time.perf_counter() - t0) * 1e3
    noised = dp_noise(inputs, gen, BASELINE_SCALE)
    noise = (noised - inputs).abs().mean().item()
    if not abs(noise - BASELINE_SCALE) <= DP_MEAN_TOL * BASELINE_SCALE:
        fail(f"dp_noise: mean |noise| {noise} is not within {DP_MEAN_TOL:.0%} of "
             f"{BASELINE_SCALE}")
    pasted = paste_patch(inputs, target, PASTE_TIMES)
    ps = size // PASTE_TIMES
    loc = (size - ps) // 2
    centre = torch.zeros_like(inputs, dtype=torch.bool)
    centre[:, loc : loc + ps, loc : loc + ps] = True
    if not (torch.equal(pasted[:, loc : loc + ps, loc : loc + ps],
                        resize_bilinear(target, ps, ps).expand(PATCH_N, -1, -1, -1))
            and torch.equal(pasted[~centre], inputs[~centre])):
        fail("paste_patch: the centre is not the resized target or the rest moved")
    more = out_domain_more(inputs, target)
    singles = [out_domain_single(inputs, target, i) for i in range(PATCH_N)]
    if not torch.equal(more, target.expand_as(inputs)):
        fail("out_domain_more: not every input is the target")
    for i, s in enumerate(singles):
        keep = torch.arange(PATCH_N, device="cuda") != i
        if not (torch.equal(s[i], target[0]) and torch.equal(s[keep], inputs[keep])):
            fail(f"out_domain_single({i}): wrong rows replaced")
    batches = dict(blur=blurred, dp_noise=noised, paste=pasted, out_domain_more=more,
                   **{f"out_domain_single_{i}": s for i, s in enumerate(singles)})
    # (e) the hybrid splice of the blur and dp batches
    spliced, counts = splice_hybrid([blurred, noised], PATCH_N)
    if counts != [3, 2] or not (torch.equal(spliced[:3], blurred[:3])
                                and torch.equal(spliced[3:], noised[3:])):
        fail(f"splice_hybrid: counts {counts} or rows not as spliced")
    batches["hybrid"] = spliced
    with torch.no_grad():
        for name, b in batches.items():
            if not (torch.isfinite(b).all() and _fuse_ok(torch, fused_fn(b))):
                fail(f"baseline {name}: non-finite inputs or fused image")
    out.update(blur_kernel_size=k, dp_mean_abs_noise=noise, hybrid_counts=counts)
    log(f"  blur_ms {out['blur_ms']:.3f} [{card}] (k={k}, {PATCH_N}x1024^2x3, two 1-D passes "
        f"as banded float32 matmuls)")
    log(f"  dp_noise mean |noise| {noise:.6f} (scale {BASELINE_SCALE}, tol {DP_MEAN_TOL:.0%}); "
        f"paste centre {ps}^2 = resized target, rest unchanged; out_domain more / single "
        f"rows as replaced; hybrid counts {counts}; {len(batches)} batches fused, all finite")

    # (f) the legacy optimize, both variants, one image: timed at the
    # reference's lr (0.01), then its descent held at the white-box lr
    lp = LPIPS(device="cuda", generator=torch.Generator(device="cuda").manual_seed(7))
    img = inputs[:1]
    for variant in ("optimize", "optimize_copy"):
        lcfg = LegacyOptimizeConfig(n_iters=LEGACY_ITERS, variant=variant,
                                    snapshot_every=LEGACY_EVERY)
        make_legacy_optimize(pipe, lp, dataclasses.replace(lcfg, n_iters=1, snapshot_every=0))(
            img, target)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        adv, trace, frames = make_legacy_optimize(pipe, lp, lcfg)(img, target)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / LEGACY_ITERS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        terms = {k: v.float().cpu().tolist() for k, v in trace.items()}
        n_frames = 1 + (LEGACY_ITERS - 1) // LEGACY_EVERY
        if frames.shape != (n_frames, 1, size, size, 3) or not torch.isfinite(adv).all():
            fail(f"legacy {variant}: frames {frames.shape}, expected {n_frames}")
        if not all(math.isfinite(v) for t in terms.values() for v in t):
            fail(f"legacy {variant}: non-finite terms {terms}")
        small = dataclasses.replace(lcfg, lr=WB_LR)
        _, small_trace, small_frames = make_legacy_optimize(pipe, lp, small)(img, target)
        total = small_trace["total"].float().cpu()
        if small_frames.shape[0] != n_frames or not total[-1] < total[0]:
            fail(f"legacy {variant} at lr {WB_LR}: the total did not fall: {total.tolist()}")
        out[f"legacy_{variant}_step_ms"] = ms
        out[f"legacy_{variant}_peak_memory_gib"] = peak
        out[f"legacy_{variant}_terms"] = terms
        out[f"legacy_{variant}_total_trace_lr{WB_LR}"] = total.tolist()
        log(f"  legacy_{variant}_step_ms {ms:.3f} [{card}] (1 image, 1024^2, {LEGACY_ITERS} "
            f"iterations at lr {lcfg.lr}, LPIPS at "
            f"{size if variant == 'optimize_copy' else pipe.encoder_input_size}^2)")
        log(f"  legacy_{variant}_peak_memory_gib {peak:.3f} [{card}]")
        log(f"  legacy {variant}, lr {lcfg.lr}: {frames.shape[0]} frames; terms {terms}")
        log(f"  legacy {variant}, lr {WB_LR}: totals {total.tolist()} fall")

    launches = ops.launch_counts()
    out["patch_phase_s"] = time.perf_counter() - t_phase
    log(f"  launches {launches} (per patch inner step {per_inner}); phase 5d "
        f"{out['patch_phase_s']:.1f} s [{card}]")
    short = patch_launch_failures(launches)
    if short:
        fail("; ".join(short))
    return launches, per_inner, out, (step, train[:1], init_patch_square(size, 0.1, gen), gen)


# ---------------------------------------------------------------------------
# phase 4 (classifier transfer): the classifiers, classifier PGD, CW, the
# discriminator and pipeline persistence at 32^2, card against CPU
# ---------------------------------------------------------------------------

# configs/ffhq_classifier_transfer.json: eps 8/255 and alpha 0.01 in [0, 1],
# doubled for the [-1, 1] range, as the runner does (runner.py:396-397)
CLF_EPS, CLF_ALPHA = 8 / 255 * 2, 0.01 * 2
SMALL_VIT = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                 intermediate_size=64)  # the runner's tiny ViT (runner.py:105-108)
SMALL_CLF_SEED, SMALL_CLF_STEPS = 11, 5
# the ViT's CW run at 32^2: some images succeed, and no step's margin comes
# within 1e-3 of 0 (the CPU run asserts it), so rounding decides no success
SMALL_CW = dict(c=10.0, steps=10, lr=0.02)
SMALL_CW_MARGIN = 1e-3
CLF_TOL = 1e-4  # logits, scores and traces, of max(1, max|CPU|); fp32, TF32 off
CLF_GRAD_TOL = 1e-3  # pixel gradients, of max|CPU grad|


def _cw_margins(torch, logits, labels):
    """CW's margin ``real - other`` of each row (``attacks/cw.py``)."""
    one_hot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).float()
    return (one_hot * logits).sum(-1) - ((1 - one_hot) * logits - one_hot * 1e9).amax(-1)


def cw_bookkeeping_failures(torch, images, best_adv, best_l2, what):
    """CW's best-iterate bookkeeping: where ``best_l2`` is inf, ``best_adv``
    is the image bit for bit; elsewhere ``best_l2`` is ``sum((best_adv -
    images)^2)`` to rtol 1e-5; pixels in [-1, 1]."""
    out = []
    won = torch.isfinite(best_l2)
    if not torch.equal(best_adv[~won], images[~won]):
        out.append(f"{what}: an image without success has moved")
    if won.any():
        l2 = ((best_adv[won].double() - images[won].double()) ** 2).sum(dim=(1, 2, 3))
        rel = ((best_l2[won].double() - l2).abs() / l2).max().item()
        if not rel <= 1e-5:
            out.append(f"{what}: best_l2 is not the L2 of best_adv (rel {rel:.3e} > 1e-5)")
    if not (best_adv.min().item() >= -1 and best_adv.max().item() <= 1):
        out.append(f"{what}: best_adv leaves [-1, 1]")
    return out


def check_classifier_small(torch, gpu):
    """Phase 4's classifier-transfer checks, card against CPU on the same
    weights (fp32 policy, TF32 off): a width-8 resnet and the tiny ViT
    (logits, pixel gradients through the 64^2 -> 32^2 resize, 5 classifier
    PGD steps from one start), the ViT's CW run (10 steps, some images
    succeed), the 32^2 discriminator at batches 4 and 3, and the 32^2
    pipeline ``gpu`` saved and loaded on the card (the fused images
    bit-identical)."""
    import copy
    import tempfile

    import torch.nn.functional as F

    from tpufusion_torch.attacks.cw import CWConfig, make_cw
    from tpufusion_torch.attacks.fusion_attack import make_fused_image_fn
    from tpufusion_torch.attacks.pgd import PGDConfig, make_pgd
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.models.classifiers import create_vit_classifier, resnet_logits_fn
    from tpufusion_torch.models.discriminator import create_discriminator, realism_scores
    from tpufusion_torch.models.resnet import ResNet
    from tpufusion_torch.pipeline import FusionPipeline

    gen = torch.Generator().manual_seed(SMALL_CLF_SEED)
    x = torch.rand((4, 64, 64, 3), generator=gen) * 2 - 1
    resnet = ResNet(2, width=8, policy=Policy(), device="cpu", generator=gen)
    vit_fn, vit = create_vit_classifier(8, policy=Policy(), device="cpu", seed=SMALL_CLF_SEED,
                                        **SMALL_VIT)
    nets = {"resnet": (resnet_logits_fn(32), resnet.requires_grad_(False)),
            "vit": (vit_fn, vit)}
    start = (x + (torch.rand(x.shape, generator=gen) * 2 - 1) * CLF_EPS).clamp(-1, 1)
    weights = torch.linspace(-1, 1, 8)
    for name, (fn, cpu_net) in nets.items():
        gpu_net = copy.deepcopy(cpu_net).cuda()
        outs = []
        for net, dev in ((cpu_net, "cpu"), (gpu_net, "cuda")):
            xa = x.to(dev).requires_grad_(True)
            logits = fn(net, xa)
            (g,) = torch.autograd.grad((logits * weights[: logits.shape[-1]].to(dev)).sum(), xa)
            outs.append((logits.detach().cpu(), g.cpu()))
        err_l = _rel(torch, outs[1][0], outs[0][0])
        err_g = ((outs[1][1] - outs[0][1]).abs().max() / outs[0][1].abs().max()).item()
        log(f"  small reference: {name} logits card vs CPU rel err {err_l:.3e} (tol "
            f"{CLF_TOL:.0e}), pixel grad rel err {err_g:.3e} (tol {CLF_GRAD_TOL:.0e})")
        if not (err_l <= CLF_TOL and err_g <= CLF_GRAD_TOL):
            fail(f"32^2 {name} on the card disagrees with the CPU: logits {err_l}, grad {err_g}")
        labels = outs[0][0].argmax(-1)

        def ce(adv, net_, y):
            return F.cross_entropy(fn(net_, adv), y)

        cfg = PGDConfig(eps=CLF_EPS, alpha=CLF_ALPHA, steps=SMALL_CLF_STEPS)
        runs = [make_pgd(ce, cfg, external_start=True)(x.to(dev), start.to(dev), net,
                                                       labels.to(dev))
                for net, dev in ((cpu_net, "cpu"), (gpu_net, "cuda"))]
        err_t = _rel(torch, runs[1][1], runs[0][1])
        moved = (runs[1][0].cpu() - runs[0][0]).abs()
        apart = (moved > 1e-6).float().mean().item()
        ball = max((a.cpu() - x).abs().max().item() for a, _ in runs)
        log(f"  small reference: {name} PGD {SMALL_CLF_STEPS} steps card vs CPU: CE trace rel "
            f"err {err_t:.3e} (tol {CLF_TOL:.0e}); pixels apart by > 1e-6: {apart:.4f} "
            f"(tol 0.01), largest {moved.max().item():.3e}; max |adv - x| {ball:.6f}")
        if not (err_t <= CLF_TOL and apart <= 0.01 and ball <= CLF_EPS + 1e-6):
            fail(f"32^2 {name} PGD on the card disagrees with the CPU: trace {err_t}, "
                 f"pixels apart {apart}, eps-ball {ball}")
        if name == "vit":
            seen = []

            def recording(im, net_):
                logits = fn(net_, im)
                if im.device.type == "cpu":
                    seen.append(logits.detach())
                return logits

            cws = [make_cw(recording, CWConfig(**SMALL_CW))(x.to(dev), labels.to(dev), net)
                   for net, dev in ((cpu_net, "cpu"), (gpu_net, "cuda"))]
            margin = torch.stack([_cw_margins(torch, lg, labels) for lg in seen]).abs().min()
            won = [torch.isfinite(l2.cpu()) for _, l2 in cws]
            if not margin > SMALL_CW_MARGIN:
                fail(f"32^2 CW: a step's margin came within {margin.item()} of 0 on the CPU")
            short = [f for (adv, l2), dev in zip(cws, ("CPU", "card"))
                     for f in cw_bookkeeping_failures(torch, x, adv.cpu(), l2.cpu(),
                                                      f"32^2 CW on the {dev}")]
            if short or not torch.equal(won[0], won[1]) or not won[0].any():
                fail(f"32^2 CW: {short}; successes CPU {won[0].tolist()}, card "
                     f"{won[1].tolist()}")
            err_l2 = ((cws[1][1].cpu()[won[0]] - cws[0][1][won[0]]).abs()
                      / cws[0][1][won[0]]).max().item()
            err_adv = (cws[1][0].cpu() - cws[0][0]).abs().max().item()
            log(f"  small reference: CW {SMALL_CW} card vs CPU: successes {won[0].tolist()}, "
                f"best_l2 rel err {err_l2:.3e} (tol 1e-4), best_adv max err {err_adv:.3e} "
                f"(tol 1e-4); closest margin to 0 {margin.item():.3e}")
            if not (err_l2 <= 1e-4 and err_adv <= 1e-4):
                fail(f"32^2 CW on the card disagrees with the CPU: {err_l2}, {err_adv}")

    d_cpu = create_discriminator(32, channel_multiplier=1, policy=Policy(), device="cpu",
                                 seed=SMALL_CLF_SEED)
    d_gpu = copy.deepcopy(d_cpu).cuda()
    imgs = torch.rand((4, 32, 32, 3), generator=gen) * 2 - 1
    for n in (4, 3):
        with torch.no_grad():
            want = realism_scores(d_cpu, imgs[:n])
            err = _rel(torch, realism_scores(d_gpu, imgs[:n].cuda()), want)
        log(f"  small reference: 32^2 realism_scores batch {n} card vs CPU rel err {err:.3e} "
            f"(tol {CLF_TOL:.0e})")
        if not err <= CLF_TOL:
            fail(f"32^2 realism scores (batch {n}) on the card disagree with the CPU: {err}")

    with tempfile.TemporaryDirectory() as tmp:
        gpu.save(tmp)
        back = FusionPipeline.load(tmp, policy=gpu.policy, device="cuda")
    differ = [f"{name}.{k}" for name in ("generator", "encoder", "vgg")
              for k, v in getattr(gpu, name).state_dict().items()
              if not torch.equal(getattr(back, name).state_dict()[k], v)]
    # The synthesis's transposed convs (cuDNN's data-grad algorithms) may
    # sum in another order from call to call: two calls of one pipeline
    # differed by 9.5e-7 on the card (PERF.md). With cuDNN's deterministic
    # algorithms a call repeats its bits, so the comparison sees only what
    # was saved and loaded.
    torch.backends.cudnn.deterministic = True
    with torch.no_grad():
        xs = x[:2, :32, :32].contiguous().cuda()
        want, again = (make_fused_image_fn(gpu)(xs) for _ in range(2))
        got = make_fused_image_fn(back)(xs)
    torch.backends.cudnn.deterministic = False
    repeat, same = torch.equal(want, again), torch.equal(got, want)
    log(f"  small reference: FusionPipeline.save -> load(device='cuda'): weights that differ "
        f"{differ}; fused image bit-identical {same} (max err "
        f"{(got - want).abs().max().item():.3e}; a second call of the saved pipeline "
        f"bit-identical {repeat}, cuDNN deterministic)")
    if differ or not (repeat and same):
        fail("the 32^2 pipeline saved and loaded on the card fuses other images")


# ---------------------------------------------------------------------------
# phase 5e: the classifier-transfer path at full width
# ---------------------------------------------------------------------------

CLF_N, CLF_STEPS = 8, 100  # bench.py's headline batch; the config's 100 PGD steps
CW_STEPS = 200  # CWConfig's default c (1e-4) and steps: the reference's CW(model, steps=200)
# a c at which the margin term outweighs the L2 term, so that some images
# succeed within a short run
CW_BIG_C, CW_BIG_STEPS = 1e4, 20
VIT_N, VIT_SIZE, VIT_STEPS = 8, 512, 100  # the car generator's size
TRANSFER_N = 5  # the ffhq fusion roles
REALISM_REPS = 5


def classifier_launch_failures(pgd_counts, cw_counts, vit_counts, transfer_counts):
    """What phase 5e's launch counts fall short of: each PGD run launches
    pgd_update once a step and fused_adam never, the CW run fused_adam once a
    step; the fusions launch styled_conv; no run launches the weight grad."""
    out = []
    for what, counts, steps in (("resnet PGD", pgd_counts, CLF_STEPS),
                                ("ViT PGD", vit_counts, VIT_STEPS)):
        if counts["pgd_update"] != steps or counts["fused_adam"] != 0:
            out.append(f"{what} ({steps} steps) launched pgd_update {counts['pgd_update']} "
                       f"and fused_adam {counts['fused_adam']} times")
    if cw_counts["fused_adam"] != CW_STEPS or cw_counts["pgd_update"] != 0:
        out.append(f"CW ({CW_STEPS} steps) launched fused_adam {cw_counts['fused_adam']} and "
                   f"pgd_update {cw_counts['pgd_update']} times")
    if transfer_counts["styled_conv"] <= 0:
        out.append("the transfer fusions launched styled_conv no time")
    for what, counts in (("resnet PGD", pgd_counts), ("CW", cw_counts),
                         ("ViT PGD", vit_counts), ("the transfer fusions", transfer_counts)):
        if counts["conv3x3_wgrad"]:
            out.append(f"{what} launched the weight grad {counts['conv3x3_wgrad']} times")
    return out


def _diff(after, before):
    return {k: after[k] - before[k] for k in after}


def _timed(torch, fn):
    """``fn()`` after a synchronize and a peak-memory reset: its result, its
    wall ms (host clock around a synchronize) and its peak GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _check_pgd_run(torch, what, images, adv, trace):
    trace = trace.float().cpu()
    dev = (adv - images).abs().max().item()
    if not (torch.isfinite(adv).all() and dev <= CLF_EPS + 1e-6):
        fail(f"{what}: adv leaves the eps-ball ({dev} > {CLF_EPS})")
    if not (adv.min().item() >= -1 and adv.max().item() <= 1):
        fail(f"{what}: adv leaves [-1, 1]")
    if not (torch.isfinite(trace).all() and trace[-1] > trace[0]):
        fail(f"{what}: the CE did not rise: {trace[0].item()} -> {trace[-1].item()}")
    return dev


def run_classifier_path(torch, card, pipe):
    """Phase 5e on the pipeline of phase 5, with the launch counts set to 0
    just before and read just after: (1) classifier PGD against a seeded
    resnet18 (2-way head, 256^2 input) on 8 1024^2 images, the config's
    budget, after a 1-step warm-up; (2) CW at the recipe's c, 200 steps, then
    20 steps at a large c; (3) PGD against ViT-B/16 (196 labels) on 8 512^2
    images, 100 steps; (4) the first five clean and PGD crops fused in both
    modes, with the partial fusions and their metrics; (5) a config-f 1024^2
    discriminator scoring the clean and adversarial fusions. Returns the
    launch counts, the launches per step (a resnet PGD step; fused_adam per
    CW step), the numbers and, for phase 6e, one call of each timed step
    by the name of its metric."""
    import torch.nn.functional as F

    from tpufusion_torch import ops
    from tpufusion_torch.attacks.cw import CWConfig, make_cw
    from tpufusion_torch.attacks.pgd import PGDConfig, make_pgd
    from tpufusion_torch.eval import benign_fusion, fused_image_metrics, partial_adv_fusion
    from tpufusion_torch.models.classifiers import create_vit_classifier, load_gender_classifier
    from tpufusion_torch.models.discriminator import create_discriminator, realism_scores

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand((CLF_N, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    xv = torch.rand((VIT_N, VIT_SIZE, VIT_SIZE, 3), generator=gen, device="cuda") * 2 - 1
    fn, resnet = load_gender_classifier(None, device="cuda", seed=7)
    vit_fn, vit = create_vit_classifier(196, device="cuda", seed=8)
    disc = create_discriminator(1024, channel_multiplier=2, device="cuda", seed=9)

    def ce_of(logits_fn):
        def ce(adv, net, labels):
            return F.cross_entropy(logits_fn(net, adv).float(), labels)
        return ce

    cfg = PGDConfig(eps=CLF_EPS, alpha=CLF_ALPHA, steps=CLF_STEPS)
    pgd = make_pgd(ce_of(fn), cfg)
    pgd1 = make_pgd(ce_of(fn), dataclasses.replace(cfg, steps=1))
    with torch.no_grad():
        labels = fn(resnet, x).argmax(-1)
        vit_labels = vit_fn(vit, xv).argmax(-1)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    out = {}

    # (1) classifier PGD
    pgd1(x, gen, resnet, labels)  # warm-up (cuDNN plans)
    before = ops.launch_counts()
    (adv, trace), ms, peak = _timed(torch, lambda: pgd(x, gen, resnet, labels))
    pgd_counts = _diff(ops.launch_counts(), before)
    dev = _check_pgd_run(torch, "classifier PGD", x, adv, trace)
    with torch.no_grad():
        flips = int((fn(resnet, adv).argmax(-1) != labels).sum())
    out.update(classifier_pgd_step_ms=ms / CLF_STEPS, classifier_pgd_peak_memory_gib=peak,
               classifier_pgd_flips=flips)
    log(f"  classifier_pgd_step_ms {ms / CLF_STEPS:.3f} [{card}] (resnet18 at 256^2, batch "
        f"{CLF_N} at 1024^2, bf16, mean of {CLF_STEPS} steps)")
    log(f"  classifier_pgd_peak_memory_gib {peak:.3f} [{card}]")
    log(f"  CE {trace[0].item():.6f} -> {trace[-1].item():.6f}; max |adv - x| {dev:.6f} (eps "
        f"{CLF_EPS:.6f}); labels flipped {flips} of {CLF_N} (random weights: not gated)")

    # (2) CW at the recipe's c, then at a large c
    def cw_of(config):
        return make_cw(lambda im, net: fn(net, im), config)

    cw_of(CWConfig(steps=1))(x, labels, resnet)  # warm-up
    before = ops.launch_counts()
    (best_adv, best_l2), ms, peak = _timed(
        torch, lambda: cw_of(CWConfig(steps=CW_STEPS))(x, labels, resnet))
    cw_counts = _diff(ops.launch_counts(), before)
    big_adv, big_l2 = cw_of(CWConfig(c=CW_BIG_C, steps=CW_BIG_STEPS))(x, labels, resnet)
    short = cw_bookkeeping_failures(torch, x, best_adv, best_l2, "CW")
    short += cw_bookkeeping_failures(torch, x, big_adv, big_l2, f"CW at c {CW_BIG_C:g}")
    wins, big_wins = int(torch.isfinite(best_l2).sum()), int(torch.isfinite(big_l2).sum())
    if not big_wins:
        short.append(f"CW at c {CW_BIG_C:g}, {CW_BIG_STEPS} steps: no image succeeded")
    if short:
        fail("; ".join(short))
    out.update(cw_step_ms=ms / CW_STEPS, cw_peak_memory_gib=peak, cw_successes=wins,
               cw_big_c_successes=big_wins)
    log(f"  cw_step_ms {ms / CW_STEPS:.3f} [{card}] (c 1e-4, batch {CLF_N} at 1024^2, mean of "
        f"{CW_STEPS} steps)")
    log(f"  cw_peak_memory_gib {peak:.3f} [{card}]")
    log(f"  CW successes {wins} of {CLF_N} at c 1e-4 (not gated), {big_wins} at c "
        f"{CW_BIG_C:g} ({CW_BIG_STEPS} steps); best_l2 {best_l2.tolist()} / {big_l2.tolist()}")

    # (3) ViT PGD
    vit_pgd = make_pgd(ce_of(vit_fn), dataclasses.replace(cfg, steps=VIT_STEPS))
    make_pgd(ce_of(vit_fn), dataclasses.replace(cfg, steps=1))(xv, gen, vit, vit_labels)
    before = ops.launch_counts()
    (vadv, vtrace), ms, peak = _timed(torch, lambda: vit_pgd(xv, gen, vit, vit_labels))
    vit_counts = _diff(ops.launch_counts(), before)
    vdev = _check_pgd_run(torch, "ViT PGD", xv, vadv, vtrace)
    with torch.no_grad():
        vflips = int((vit_fn(vit, vadv).argmax(-1) != vit_labels).sum())
    out.update(vit_pgd_step_ms=ms / VIT_STEPS, vit_pgd_peak_memory_gib=peak,
               vit_pgd_flips=vflips)
    log(f"  vit_pgd_step_ms {ms / VIT_STEPS:.3f} [{card}] (ViT-B/16 at 224^2, 196 labels, "
        f"batch {VIT_N} at {VIT_SIZE}^2, bf16, mean of {VIT_STEPS} steps)")
    log(f"  vit_pgd_peak_memory_gib {peak:.3f} [{card}]")
    log(f"  CE {vtrace[0].item():.6f} -> {vtrace[-1].item():.6f}; max |adv - x| {vdev:.6f}; "
        f"labels flipped {vflips} of {VIT_N} (not gated)")

    # (4) the first five clean and PGD crops into fusion, as adv_generate
    before = ops.launch_counts()
    with torch.no_grad():
        clean = pipe.get_latents(x[:TRANSFER_N])
        attacked = pipe.get_latents(adv[:TRANSFER_N])
        fused, metrics = {}, {}
        for m in FUSION_MODES:
            benign = benign_fusion(pipe.drawer, clean, m)[0]
            part = partial_adv_fusion(pipe.drawer, clean, attacked, m)
            fused[m] = (benign, part)
            metrics[m] = [v.tolist() for v in fused_image_metrics(pipe, benign, part)]
    transfer_counts = _diff(ops.launch_counts(), before)
    for m, (benign, part) in fused.items():
        if not (_fuse_ok(torch, benign) and _fuse_ok(torch, part, TRANSFER_N + 1)):
            fail(f"the {m} transfer fusions are not finite 1024^2 images")
        log(f"  transfer {m}: partial metrics mse {metrics[m][0]}, vgg {metrics[m][1]}, "
            f"ssim {metrics[m][2]}")

    # (5) realism of the clean and all-adversarial fusions, both modes
    batch = torch.cat([t for m in FUSION_MODES for t in (fused[m][0], fused[m][1][-1:])])
    with torch.no_grad():
        realism_scores(disc, batch)  # warm-up
        scores, ms, peak = _timed(torch, lambda: [realism_scores(disc, batch)
                                                  for _ in range(REALISM_REPS)][-1])
    if tuple(scores.shape) != (len(batch),) or not torch.isfinite(scores).all():
        fail(f"realism scores {scores.tolist()} not finite or of the wrong shape")
    out.update(realism_ms=ms / REALISM_REPS, realism_peak_memory_gib=peak,
               realism_scores=scores.float().tolist(), transfer_metrics=metrics)
    log(f"  realism_ms {ms / REALISM_REPS:.3f} [{card}] (config-f 1024^2 discriminator, batch "
        f"{len(batch)}, bf16, mean of {REALISM_REPS})")
    log(f"  realism_peak_memory_gib {peak:.3f} [{card}]")
    log(f"  realism scores (spatial clean, spatial adversarial, arithmetic clean, arithmetic "
        f"adversarial): {scores.float().tolist()}")

    launches = ops.launch_counts()
    out["classifier_phase_s"] = time.perf_counter() - t_phase
    short = classifier_launch_failures(pgd_counts, cw_counts, vit_counts, transfer_counts)
    if short:
        fail("; ".join(short))
    per_step = {k: v / CLF_STEPS for k, v in pgd_counts.items()}
    per_step["fused_adam"] = cw_counts["fused_adam"] / CW_STEPS
    log(f"  launches {launches} (resnet PGD {pgd_counts}; CW {cw_counts}; ViT PGD "
        f"{vit_counts}; transfer fusions {transfer_counts}); phase 5e "
        f"{out['classifier_phase_s']:.1f} s [{card}]")
    cw1 = cw_of(CWConfig(steps=1))
    vit1 = make_pgd(ce_of(vit_fn), dataclasses.replace(cfg, steps=1))
    steps = {"classifier_pgd_step_ms": lambda: pgd1(x, gen, resnet, labels),
             "cw_step_ms": lambda: cw1(x, labels, resnet),
             "vit_pgd_step_ms": lambda: vit1(xv, gen, vit, vit_labels),
             "realism_ms": lambda: realism_scores(disc, batch)}
    return launches, per_step, out, steps


def time_blender(torch, card, pipe, reps=5):
    """One full-width blender forward + backward (5 internal nodes x 26 style
    layers, batch 1, the pipeline's compute dtype): host ms until the calls
    return and wall ms after a synchronize (host clock), the stream's ms
    between two CUDA events; then device busy ms and launches from the
    profiler."""
    blender = pipe.drawer.blender
    gen = torch.Generator(device="cuda").manual_seed(4)
    dt = pipe.policy.compute_dtype
    roles = [tuple(torch.randn((1, d), generator=gen, device="cuda").to(dt).requires_grad_(True)
                   for d in pipe.generator.style_input_dims()) for _ in range(SPATIAL_N)]
    s_dict = {p: roles[i % SPATIAL_N] for i, p in enumerate(pipe.drawer.parts)}
    leaves = [t for r in roles for t in r]
    grad_out = [torch.ones_like(o) for o in blender(s_dict)]

    def run():
        torch.autograd.grad(blender(s_dict), leaves, grad_outputs=grad_out)

    run()
    torch.cuda.synchronize()
    host, wall, stream = [], [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        stream.append(start.elapsed_time(end))
    log(f"  blender forward + backward [{card}]: host {min(host):.3f}-{max(host):.3f} ms, "
        f"wall {min(wall):.3f}-{max(wall):.3f} ms, CUDA events {min(stream):.3f}-"
        f"{max(stream):.3f} ms ({reps} runs)")
    prof = profile_step(torch, run, step_ms=min(wall), what="blender wall ms")
    return dict(host_ms=host, wall_ms=wall, event_ms=stream, profile=prof)


# substrings of the profiler's kernel names -> phase 6/6b's groups (the first
# that matches); the styled and plain instantiations of the shared conv
# kernels, and their fp32 (CUDA cores) and bf16 (tensor cores) routes, apart
KERNEL_NAMES = (("conv3x3_mma_kernel<true", "styled_conv bf16"),
                ("conv3x3_mma_kernel<false", "conv3x3_fwd/dgrad bf16"),
                ("conv3x3_fwd_kernel<float, true>", "styled_conv fp32"),
                ("conv3x3_fwd_kernel<float, false>", "conv3x3_fwd/dgrad fp32"),
                ("conv3x3_wgrad_mma_kernel", "conv3x3_wgrad bf16"),
                ("conv3x3_wgrad_kernel", "conv3x3_wgrad fp32"),
                ("sum_partials_kernel", "conv3x3_wgrad second pass"),
                ("pgd_kernel", "pgd_update"),
                ("adam_kernel", "fused_adam"))


def _device_rows(prof):
    """``(kernel name, device ms, calls)`` of every kernel a profile saw."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)) / 1e3
        if ms > 0:
            rows.append((e.key, ms, e.count))
    return rows


def device_ms_by_group(torch, run, iters=5):
    """Device ms per call of ``run`` by ``KERNEL_NAMES`` group, from
    torch.profiler over ``iters`` calls after a warm-up call; empty when the
    profiler saw no device time. A kernel's time per call is its mean time
    times its launches per call, so a launch that the profiler missed while
    starting up does not shorten it."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    groups: dict = {}
    for key, ms, count in _device_rows(prof):
        group = next((g for pat, g in KERNEL_NAMES if pat in key), "other kernels")
        groups[group] = groups.get(group, 0.0) + ms / count * max(1, round(count / iters))
    return groups


def profile_step(torch, run, *, step_ms, what):
    """Device time by kernel for one call of ``run`` (one attack step, after
    a warm-up call), against the unprofiled step time ``step_ms`` of the
    metric named ``what``."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        log("  the profiler saw no device time (not measured)")
        return dict(wall_ms=wall_ms, device_ms=None)
    launches = sum(c for key, _, c in rows if not key.startswith(("Memcpy", "Memset")))
    groups: dict = {}
    for key, ms, _ in rows:
        group = next((g for pat, g in KERNEL_NAMES if pat in key), "other kernels")
        groups[group] = groups.get(group, 0.0) + ms
    log(f"  step wall {wall_ms:.3f} ms with the profiler on, device busy {busy:.3f} ms: "
        f"idle share {1 - busy / wall_ms:.3f} of the profiled step, "
        f"{1 - busy / step_ms:.3f} of the unprofiled {what} {step_ms:.3f}; "
        f"{launches} kernel launches")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:20s} {ms:9.3f} ms  {ms / busy:6.1%}")
    log("  top kernels:")
    for key, ms, count in rows[:12]:
        log(f"    {ms:9.3f} ms  x{count:<4d} {key[:110]}")
    return dict(wall_ms=wall_ms, device_ms=busy, idle_share=1 - busy / step_ms,
                kernel_launches=launches, groups=groups,
                top=[dict(kernel=k, ms=ms, count=c) for k, ms, c in rows[:40]])


def ptxas_summary(text: str):
    """``(kernel, registers, spilled bytes)`` for each entry function in
    nvcc's ``-Xptxas=-v`` output; a tensor-core kernel's tile class is
    shown by its ``MmaTile`` / ``WgradTile`` arguments."""
    rows, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_ZN2tf(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            name, rest = m.group(2)[:n], m.group(2)[n:]
            tile = re.search(r"(MmaTile|WgradTile)I((?:L[ib]\d+E)+)", rest)
            if tile:
                args = ", ".join(re.findall(r"L[ib](\d+)E", tile.group(2)))
                kind = "" if tile.group(1) == "WgradTile" else \
                    ("styled, " if rest.startswith("ILb1") else "plain, ")
                name += f"<{kind}{tile.group(1)}<{args}>>"
            elif rest.startswith("I"):
                dtype = "float" if rest[1] == "f" else "bf16"
                name += f"<{dtype}{', styled' if rest[2:6] == 'Lb1E' else ''}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


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
    for source in ("styled_conv", "conv3x3"):
        for kernel, regs, spill in ptxas_summary(
                (_lib.BUILD_DIR / f"{source}.ptxas.txt").read_text()):
            log(f"  {source}.cu {kernel}: {regs} registers, {spill} bytes spilled")

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

    log("== 5c. main path: FFHQ 1024^2 spatial-fusion attack and partial evaluation, N=5, "
        "full width")
    sp_launches, sp_per_step, sp_numbers, sp_args = run_spatial_path(torch, card, attack_args[0])
    main_numbers.update(sp_numbers)

    log("== 5d. main path: FFHQ 1024^2 patch training, baselines, hybrid splice and legacy "
        "optimize, N=5, full width")
    pa_launches, pa_per_step, pa_numbers, pa_batch = run_patch_path(torch, card, attack_args[0])
    main_numbers.update(pa_numbers)

    log("== 5e. main path: classifier transfer at full width: resnet18 PGD and CW on 8 x "
        "1024^2, ViT-B/16 PGD on 8 x 512^2, the PGD crops fused, a 1024^2 discriminator")
    cl_launches, cl_per_step, cl_numbers, cl_step = run_classifier_path(
        torch, card, attack_args[0])
    main_numbers.update(cl_numbers)

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
    log("== 6c. where the time goes: one spatial PGD step under torch.profiler; the blender")
    sp_cfg, sp_inputs, sp_target, sp_gen = sp_args
    sp_step = make_fusion_attack(pipe, dataclasses.replace(
        sp_cfg, pgd=dataclasses.replace(sp_cfg.pgd, steps=1)))
    sp_profile = profile_step(torch, lambda: sp_step(sp_inputs, sp_target, sp_gen),
                              step_ms=main_numbers["spatial_pgd_step_ms"],
                              what="spatial_pgd_step_ms")
    sp_profile["blender"] = time_blender(torch, card, pipe)
    log(f"== 6d. where the time goes: one patch batch ({PATCH_COUNT} inner steps) under "
        "torch.profiler")
    pa_step, pa_img, pa_patch, pa_gen = pa_batch
    pa_profile = profile_step(torch, lambda: pa_step(pa_img, pa_patch, pa_gen),
                              step_ms=main_numbers["patch_inner_step_ms"] * PATCH_COUNT,
                              what=f"patch batch ({PATCH_COUNT} x patch_inner_step_ms)")
    if pa_profile.get("device_ms") is not None:
        log(f"  per patch inner step: device busy {pa_profile['device_ms'] / PATCH_COUNT:.3f} ms, "
            f"{pa_profile['kernel_launches'] / PATCH_COUNT:.1f} kernel launches [{card}]")

    log("== 6e. where the time goes: one classifier PGD step, one CW step, one ViT PGD "
        "step and one realism batch under torch.profiler")
    cl_profile = {}
    for metric, run in cl_step.items():
        log(f"  -- {metric}")
        with torch.no_grad() if metric == "realism_ms" else contextlib.nullcontext():
            cl_profile[metric] = profile_step(torch, run, step_ms=main_numbers[metric],
                                              what=metric)

    # after the main paths, so that a training-style backward's allocations
    # and cuDNN plans leave their times and peak memories as they were
    log("== 3b. the weight grad through styled_conv's and the generator's backward")
    chain = check_weight_grad_chain(torch)

    kernels = summarize(records, {"pgd": (launches, per_step),
                                  "whitebox": (wb_launches, wb_per_step),
                                  "spatial": (sp_launches, sp_per_step),
                                  "patch": (pa_launches, pa_per_step),
                                  "classifier": (cl_launches, cl_per_step)})
    out_dir = os.path.join(HERE, "runs", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_kernels.json"), "w") as f:
        json.dump(dict(card=card, records=records, kernels=kernels, main=main_numbers,
                       profile=profile, whitebox_profile=wb_profile,
                       spatial_profile=sp_profile,
                       patch_profile=pa_profile, classifier_profile=cl_profile,
                       weight_grad_chain=chain), f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

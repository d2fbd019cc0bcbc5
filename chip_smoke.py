#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``tpufusion_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the CUDA sources under ``tpufusion_torch/csrc`` compile into
   ``build/tpufusion_torch`` (one nvcc per source, in parallel); the conv
   kernels' registers and spills, from ptxas, and any wgmma serialization
   ptxas reports; the SASS gate (``cuobjdump -sass``): every bf16 conv
   kernel (the forward's ``conv3x3_wgmma_kernel``, each tile class, and the
   weight grad's ``conv3x3_wgrad_wgmma_kernel``, each channel count) issues
   HGMMA and UTMALDG and no HMMA;
3. kernels against their plain PyTorch versions on the card, at the shapes
   of the main paths (fusion PGD, batch 1 synthesis; white-box, batch 5;
   spatial fusion: batch 1 in the attack, batch 6 in the partial-fusion
   evaluation, 5 inputs for pgd_update; classifier transfer: pgd_update and
   fused_adam on 8 x 1024^2 x 3, pgd_update on 8 x 512^2 x 3 untimed;
   phase 5h's car and church: styled_conv at batch 4 over the 512^2
   generator's shapes and batch 3 over the 256^2 one's, conv3x3 at
   4 x 512^2 c64, pgd_update and fused_adam on 4 x 512^2 x 3 and
   3 x 256^2 x 3; styled_conv_up, bf16 only, at the synthesis's up convs
   at the white-box batch 5 and car's batch 4, held to the folded
   composite and timed beside the unfolded chain it replaced; the styled
   convs' backward pair, bf16 only, at every styled and up conv of the same
   two syntheses, held to its plain twin with the bias off the activation's
   kink and with a synthesis's bias (the sign of z from the forward
   kernel's y), two launches bit-equal, and timed alone and wrapped beside
   the recomputed composite it replaced),
   in float32 (TF32 off) and bfloat16, with times, and untimed at the
   ragged tile and TMA-box edges of the bf16 forward (planes not a multiple
   of the tile, 1-3 pixels a side, Cin 48, Cout 96, bf16 inputs 2 bytes off
   a 16-byte boundary), each styled_conv and conv3x3 case launched twice and
   held bit-equal; the weight grad
   also at tiny and ragged planes where the border is a large share of the
   sum, to its own 1e-3 limit, with two launches giving the same bits;
   the bf16 conv kernels (styled_conv, conv3x3 forward, input grad and
   weight grad) are timed by CUDA-graph replay, all device ms: the kernel
   alone (its launch prepared first, ``*_launcher``; the weight grad's with
   its second pass) on a cold L2 (launches rotating over copies of the
   inputs, the forward's each with its own packed weights) and warm; the
   wrapper (weight packing, and styled_conv's scale, sigma and noise plane)
   cold and warm (``graph_ms``, phase 3's reading before the Hopper
   redesign), with its host us a call; the plain twin (the weight grad's
   by ``time_ms``) and the yardsticks cold: cuDNN's conv core beside
   styled_conv (``conv_core_library_ms``), ``F.conv2d`` / ``conv2d_input``
   / ``conv2d_weight`` beside conv3x3; each record names its tile class
   (``mma_class``);
   pgd_update and fused_adam are held bit-exact also on views 4 bytes off
   a 16-byte boundary (all streams, and one stream alone), and timed three
   ways at every timed shape: the device ms a launch with the card never
   waiting on the host (``GRAPH_LAUNCHES`` launches captured in one CUDA
   graph, replayed between CUDA events), on a cold L2 (the launches cycle
   over copies of the buffers, ~192 MB apart) and back to back on the same
   buffers (warm), the host us a wrapper call
   (``time.perf_counter`` over ``HOST_CALLS`` calls, no synchronize inside)
   and ``time_ms``'s reading (events around back-to-back calls, the host's
   time where a call is short), beside the launch floor: an empty kernel
   timed the same ways;
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
   car's and church's spatial fused images of 4 and 3 inputs and their
   pixel and 'vgg' gradients; a width-8 resnet and the
   tiny ViT (logits, pixel gradients, 5 classifier PGD steps), a 10-step CW
   run where images succeed, the 32^2 discriminator at batches 4 and 3, and
   the 32^2 pipeline saved and loaded on the card (bit-identical fusions);
5. the fusion main path at full width: the FFHQ 1024^2 config-f generator +
   e4e IR-SE-50 + VGG16 pipeline (seeded random weights), one fused-image
   forward, FGSM, and PGD with the default eps/alpha for 5 steps after a
   warm-up, with every kernel's launch count read around that run. An
   attack's step runs on its program (``tpufusion_torch/core/graphs.py``):
   the first step eager, then the capture, every later step a CUDA graph
   replay. From phase 5 on, the first replay of every program runs under
   torch.profiler and each wrapper's kernel rows must equal the launches
   that the program adds to the counts at a replay (``LaunchAudit``); the
   counts of every counted run read each replay at its measured counts.
   The PGD attack is called twice from one start: the first call timed on
   its new program (``first_call_ms``, its ``capture_ms`` apart), the
   second timed over replays (``pgd_step_ms``), beside the host us of one
   replay, the peak memory and each kernel's launches a replay. Outside the
   counted run the same attack object is called again with deterministic
   algorithms required (its cache keys on the flags, so it captures anew):
   its replays are timed and held bit for bit to the eager twin
   (``attacks/pgd.py::pgd_eager``, timed too) from the same start, and a
   replay must launch each kernel as often as an eager step. Under the
   default flags no hold can be bit for bit: two eager runs part. 5b, 5c,
   5e and 5h time and hold their attacks the same way (classifier PGD and
   CW within 1e-6; ViT PGD is timed, not held), and free each attack's
   graphs before the next phase;
5b. the white-box main path at full width on the same pipeline
   (``configs/ffhq_whitebox.json``: N = 5 inputs all attacked toward one
   target, PRESET_ATTACK_MAIN, lr 1e-4): one warm-up iteration, then a
   5-iteration ``run_whitebox`` and its per-image attack timed over
   replays, with the launch counts read around them, then the graph held to
   ``whitebox.run_eager``;
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
   spatial PGD step (6c) (each one graph replay), one patch batch (6d) and
   one classifier PGD step, CW step, ViT PGD step (graphed attacks) and
   realism batch (6e), from torch.profiler, with the step's kernel
   launches and the idle share against the step's unprofiled ms; 6c also
   times one full-width blender forward + backward; 5h profiles each
   family's arithmetic PGD, spatial PGD and white-box replay the same way;
5f. the attack_run CLI at full width (run after 6-6e and 3b, so that
   every earlier number reads as before): 5 synthetic 1024^2 faces written
   as PNGs; the packaged landmark net on the card held to the CPU within
   1 px at 1024^2 (landmarks and alignment-quad corners); then
   ``tpufusion_torch.cli.attack_run.main`` in this process with
   ``--images_dir --align`` and fusion_pgd_arith, white_box_target and blur
   (2 steps each), building its own config-f 1024^2 pipeline, with the
   launch counts read around the call, each attack's time, and its run
   folders checked (parameters, finite results.jsonl, readable
   new_mask.xlsx, 5 x 1024^2 all_adv_inputs.npz, the PGD images in the
   eps-ball and [-1, 1]); then ``invert`` and ``fuse`` at --tiny on the
   card;
5g. the scale-out routes (run after 5f, so that every earlier number reads
   as before) on a one-rank NCCL ``('data', 'model')`` mesh over the card,
   the pipeline of phase 5: the host time of a ``tpufusion::styled_conv``
   call against the bare launch; then, with cudnn.deterministic on and
   deterministic algorithms required, each single-device route (outside
   the counted runs), then each sharded route, held bit-equal to it (the
   patch, to the step written out, within 1e-5 + 1e-4 of its largest
   value; CW within 1e-6), then each sharded and each single-device route again,
   timed against each other (the counted run profiles its programs' first
   replays, so it is not timed): ``run_whitebox_sharded`` (N = 5, 2 iterations),
   ``run_pgd_sharded`` (the runner's PGD, N = 5, 2 steps, one explicit
   start), ``run_cw_sharded`` (resnet18, 8 x 1024^2, 5 steps),
   ``train_patch_sharded`` (1 epoch, 2 images, max_count 2), the group
   fusion attack (G = 2 groups of N = 5, both modes, 2 steps) and the group
   evaluation; a DCP checkpoint of the white-box state (bytes, save and
   restore seconds) and a white-box run interrupted after one iteration and
   resumed, bit-equal to the whole run; ``export_decode`` and
   ``export_spatial_fusion`` at 1024^2 on the card, saved, loaded, holding
   the ``tpufusion::styled_conv`` node and bit-equal to the eager forwards
   (export and load seconds, bytes, forward ms). The launch counts are set
   to 0 just before and read just after each of three runs: the sharded
   routes (styled_conv, both styled backward pairs, pgd_update and
   fused_adam each launched), the DCP resume (all but pgd_update) and the
   exported programs' forwards (styled_conv);
5h. the car (512^2, N = 4) and church (256^2, N = 3) families at their
   published widths (run after 5g, so that every earlier number reads as
   before): for each, ``FusionPipeline.create`` of the family (config-f
   generator, e4e IR-SE-50 at 256^2, VGG16, seeded random weights), three
   timed fused forwards, FGSM and 3 arithmetic fusion-PGD steps, FGSM and
   3 spatial ('vgg') steps with the partial-fusion evaluation of both
   modes, 3 white-box iterations (PRESET_ATTACK_MAIN, lr 1e-4), one patch
   epoch (1 image x 2 inner steps), classifier PGD through the family's
   surrogate (car: ViT-B/16, 196 labels, and CW; church: resnet18), 3
   steps each; then ``attack_run`` in this process with
   ``configs/<family>_whitebox.json`` on N images written to disk
   (white_box_target, fusion_pgd_spatial and blur at 2 steps), ``invert
   --dataset car`` (384 x 512 inversions) and ``fuse``. The launch counts
   are read around each run and held to the generator's ``conv_plan()``:
   styled_conv 8 (car) or 7 (church) a synthesis, a styled backward pair
   at least once a step for each of its styled and up convs, never the
   recomputed composite nor conv3x3's kernels, pgd_update once a PGD step,
   fused_adam once a white-box iteration and a CW step;
7. the kernels line (JSON, one object) and the last line
   ``{"ok": true, "device": {...}}``.

Per-shape kernel numbers also go to ``runs/chip_smoke/chip_smoke_kernels.json``.
``python3 chip_smoke.py --kernels-only`` runs phases 1-3 alone, writes that
file and prints no result line: the quick reading of the kernels.
``python3 chip_smoke.py --first-calls`` builds the kernels, then times each
attack the runner dispatches at its config's step count on a new attack
object, a second call and the eager twin (``run_first_calls``), writes
``runs/chip_smoke/first_calls.json`` and prints no result line.
This script imports nothing of JAX or of the JAX package ``tpufusion``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
    """Mean ms a call of ``fn`` by CUDA events around ``iters`` back-to-back
    calls. Where a call's host work (checks, allocation, the launch) takes
    longer than its kernels, the card waits for the host between calls and
    this reads the host's time, not the device's: ``graph_ms`` reads a
    short kernel's device time."""
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


GRAPH_LAUNCHES = 20  # calls captured in one CUDA graph
GRAPH_REPLAYS = 5
HOST_CALLS = 100  # far below the launch queue's depth, so the host never waits
HOST_REPEATS = 3


SETTLE_BYTES = 1 << 30  # a release of cached device memory larger than this ...
SETTLE_S = 0.1  # ... is waited out for this long before a timing


def release_cache(torch):
    """Give the allocator's cached blocks back to CUDA (``empty_cache``),
    and wait ``SETTLE_S`` where that freed more than ``SETTLE_BYTES``. For some ms
    after a large release (13 GiB once phase 3's conv cases have run),
    memory-bound kernels run slower: without the wait, phase 3 read
    ``pgd_update`` at 2 x 1024^2 x 3 about 15% slow (PERF.md section 6)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    if before - torch.cuda.memory_reserved() > SETTLE_BYTES:
        time.sleep(SETTLE_S)


def graph_ms(torch, fn, launches=GRAPH_LAUNCHES, replays=GRAPH_REPLAYS):
    """Device ms a call of ``fn`` with the card never waiting on the host:
    ``launches`` calls captured in one CUDA graph, the graph replayed
    ``replays`` times, each replay between CUDA events; the ms a call of
    each replay, sorted. ``fn`` must be capturable (its outputs come from
    the graph's own memory pool). ``torch.cuda.graph`` empties the
    allocator's cache as its capture starts, so the cache is released, and
    a large release waited out, before anything is timed."""
    release_cache(torch)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / launches)
    del graph
    return sorted(per)


def host_us(torch, fn, calls=HOST_CALLS, repeats=HOST_REPEATS):
    """Host us a call of ``fn``: ``time.perf_counter`` over ``calls`` calls
    with no synchronize inside (the card runs behind and the host never
    waits for it), ``repeats`` times; sorted."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return sorted(per)


COLD_BYTES = 192 << 20  # bytes passed between two uses of a buffer: ~4x the 50 MB L2


def cold_ms(torch, call, tensors):
    """Device ms a call of ``call(*tensors)`` on a cold L2, as a step finds
    the pixel buffers: ``graph_ms`` with the captured launches cycling over
    copies of ``tensors``, so many that more than ``COLD_BYTES`` of the
    other copies pass between two uses of one. Sorted, one a replay."""
    set_bytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = max(2, min(GRAPH_LAUNCHES, -(-COLD_BYTES // set_bytes) + 1))
    sets = [tensors] + [[t.clone() for t in tensors] for _ in range(copies - 1)]
    turn = [0]

    def rotating():
        turn[0] += 1
        return call(*sets[turn[0] % copies])
    ms = graph_ms(torch, rotating)
    del sets
    return ms


# An empty kernel, launched through the port's launch helper as every kernel
# is: the floor under a pixel update's device ms and host us.
FLOOR_SRC = r"""// An empty kernel: what any launch costs (chip_smoke.py phase 3).
#include <cuda_runtime.h>
__global__ void tf_empty_kernel() {}
extern "C" int tf_empty(int blocks, int threads, void* stream) {
  tf_empty_kernel<<<blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def start_floor_build(_lib):
    """Start nvcc on the empty kernel (beside phase 2's builds); returns the
    process and the library's path."""
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _lib.BUILD_DIR / "launch_floor.cu"
    src.write_text(FLOOR_SRC)
    so = _lib.BUILD_DIR / "liblaunch_floor.so"
    cmd = [_lib.nvcc_path(), *_lib.NVCC_FLAGS, "-o", str(so), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def finish_floor_build(proc, so):
    import ctypes

    out, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc launch_floor.cu failed ({proc.returncode}):\n{out}")
    lib = ctypes.CDLL(str(so))
    lib.tf_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.tf_empty.restype = ctypes.c_int
    return lib


def launch_floor(torch, lib, card):
    """The empty kernel's device ms a launch (one block, and one block of
    256 threads for each of 4 x the SMs) and host us a launch, timed as the
    pixel updates are."""
    from tpufusion_torch.ops import _lib

    t = torch.empty(1, device="cuda")
    grid = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    one = graph_ms(torch, lambda: _lib.launch(lib.tf_empty, t, "empty kernel", 1, 256))
    full = graph_ms(torch, lambda: _lib.launch(lib.tf_empty, t, "empty kernel", grid, 256))
    host = host_us(torch, lambda: _lib.launch(lib.tf_empty, t, "empty kernel", 1, 256))
    log(f"  launch floor (empty kernel): device {statistics.median(one) * 1e3:.2f} us a launch of 1 "
        f"block ({one[0] * 1e3:.2f}-{one[-1] * 1e3:.2f}), {statistics.median(full) * 1e3:.2f} us of "
        f"{grid} blocks ({full[0] * 1e3:.2f}-{full[-1] * 1e3:.2f}); host "
        f"{statistics.median(host):.2f} us a launch ({host[0]:.2f}-{host[-1]:.2f}) [{card}]")
    return dict(floor_ms=statistics.median(one), floor_ms_range=[one[0], one[-1]],
                floor_grid_ms=statistics.median(full), floor_grid_blocks=grid,
                floor_host_us=statistics.median(host), floor_host_us_range=[host[0], host[-1]])


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
# phase 5h's families: (fusion batch N, generator size) by the path's name;
# styled_conv at the N-image synthesis of each of the family's shapes
FAMILY_STYLED = {"car": (4, 512), "church": (3, 256)}
CONV_SHAPES = {(1, 1024, 32): "pgd", (1, 512, 64): "pgd", (2, 512, 64): None,
               (5, 1024, 32): "whitebox", (5, 512, 64): "whitebox", (4, 512, 64): "car"}
# ragged edges of the bf16 forward's tiles and TMA boxes, checked untimed
# (ops/conv3x3.py::mma_class names each case's class; the tests hold that
# these lists reach every class and edge): styled_conv (n, h, w, cin, cout)
# -- planes not a multiple of the tile in H and W, H or W of 1-3 (the box
# mostly outside the tensor), Cin 48 (a partial channel chunk: 32 + 16 in
# Narrow32's two resident chunks, 48 of Narrow64's 64, Mid's and Small's
# 32 + 16), Cout 96 (three Small slices), a plane whose tiles leave the
# last blocks' second warpgroup one tile short; conv3x3 (n, h, w, c) --
# partial tiles of both Narrow classes, planes of 1-3 pixels a side
STYLED_RAGGED = [(3, 70, 90, 128, 256), (4, 30, 20, 48, 192), (3, 3, 37, 48, 96),
                 (1, 1, 1, 32, 32), (2, 2, 3, 48, 64), (3, 19, 35, 32, 32), (1, 33, 17, 48, 32),
                 (2, 13, 21, 64, 64), (2, 5, 9, 512, 512), (30, 50, 2, 128, 128),
                 (2, 30, 50, 128, 192), (5, 3, 1, 512, 512), (3, 200, 190, 32, 32)]
CONV_RAGGED = [(2, 37, 53, 64), (1, 33, 70, 32), (3, 1, 2, 32), (2, 3, 1, 64), (1, 130, 257, 64)]
# styled_conv_up (bf16 only): the synthesis's up convs, (input plane, Cin,
# Cout), x (N, h, h, Cin) -> y (N, 2h, 2h, Cout), timed at the white-box
# batch (FFHQ's 8) and car's (its 7, to 512^2); then ragged edges untimed
# (every tile class of the phase conv Cin -> 4 Cout, planes not a multiple
# of the tile, 1-3 pixels a side, Cout 8-24 where an 8-channel part or a
# block holds several phases)
UP_SHAPES = [(4, 512, 512), (8, 512, 512), (16, 512, 512), (32, 512, 512), (64, 512, 256),
             (128, 256, 128), (256, 128, 64), (512, 64, 32)]
UP_BATCHES = {5: ("whitebox", 1024), 4: ("car", 512)}
UP_RAGGED = [(2, 13, 13, 64, 8), (2, 40, 40, 32, 16), (1, 3, 37, 64, 64), (3, 70, 90, 128, 64),
             (1, 9, 21, 48, 32), (4, 30, 20, 48, 48), (1, 1, 1, 32, 32), (2, 2, 3, 48, 16),
             (3, 16, 16, 512, 512), (2, 33, 17, 16, 24)]
# the styled convs' backward (bf16, K1 + K2): timed at every styled and up
# conv of the white-box (batch 5) and car (batch 4) synthesis, (kind, plane,
# Cin, Cout) with x (N, h, h, Cin); then the ragged edges untimed, the
# cases of STYLED_RAGGED and UP_RAGGED that K2 takes (Cin % 32 == 0),
# (n, h, w, cin, cout, up)
BWD_SHAPES = ([("conv", res, ch, ch) for res, ch in STYLED_SHAPES]
              + [("up", h, cin, cout) for h, cin, cout in UP_SHAPES])
BWD_RAGGED = ([(*shape, False) for shape in STYLED_RAGGED if shape[3] % 32 == 0]
              + [(*shape, True) for shape in UP_RAGGED if shape[3] % 32 == 0])
# bf16 inputs 2 bytes past a 16-byte boundary (the wrappers copy them to an
# aligned buffer for the TMA): styled_conv and conv3x3 cases of the lists above
VIEW_OFF = {"styled": (3, 19, 35, 32, 32), "conv": (2, 37, 53, 64)}
# weight grad only, untimed: planes where the zero border and the partial
# tiles are a large share of the sum (a single pixel: 8 of 9 taps read only
# padding; a plane narrower than a k-step; one row and column past a tile;
# ragged tiles of each class several tiles each way; the tests hold that
# these reach every class of ops/conv3x3.py::WGRAD_CLASSES and its edges)
WGRAD_RAGGED = [(1, 1, 1, 32), (1, 3, 37, 64), (2, 17, 16, 32), (3, 37, 53, 64),
                (2, 33, 70, 32)]
# the white-box batch, the legacy optimize's one image (phase 5d), CW's
# batch of 8 (phase 5e) and phase 5h's white-box and CW batches
ADAM_SHAPES = {(5, 1024, 1024, 3): "whitebox", (1, 1024, 1024, 3): "patch",
               (8, 1024, 1024, 3): "classifier", (4, 512, 512, 3): "car",
               (3, 256, 256, 3): "church", (3, 37, 53, 3): None}
# phase 5e's resnet PGD is timed; its ViT PGD (8 x 512^2) is checked untimed
PGD_SHAPES = {(2, 1024, 1024, 3): "pgd", (5, 1024, 1024, 3): "spatial",
              (8, 1024, 1024, 3): "classifier", (8, 512, 512, 3): None,
              (4, 512, 512, 3): "car", (3, 256, 256, 3): "church", (3, 37, 53, 3): None}
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


# views of the pixel updates' streams, bytes past a 16-byte boundary: (every
# stream but the second, the second) -- all aligned, all 4 bytes off (the
# body still streams), and one stream alone off (the scalar path throughout)
PIXEL_OFFSETS = {"": (0, 0), " unaligned": (4, 4), " mixed offsets": (0, 4)}


def offset_copy(torch, t, nbytes):
    """A contiguous copy of ``t`` starting ``nbytes`` past a 16-byte boundary."""
    k = nbytes // t.element_size()
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    return buf[k:].copy_(t.reshape(-1)).view(t.shape)


def pixel_timings(torch, call, tensors, bound):
    """A pixel update's readings for ``call(*tensors)``: device ms a launch
    on a cold L2 (the record's ms) and back to back on the same buffers
    (``warm_ms``: what the L2 keeps of them between launches helps), both by
    graph replay; host us a wrapper call; ``time_ms``'s reading; the share
    of the bound (cold)."""
    def fn():
        return call(*tensors)
    cold = cold_ms(torch, call, tensors)
    warm = graph_ms(torch, fn)
    host = host_us(torch, fn)
    return dict(ms=statistics.median(cold), graph_ms_range=[cold[0], cold[-1]], warm_ms=statistics.median(warm),
                warm_ms_range=[warm[0], warm[-1]], event_ms=time_ms(torch, fn),
                host_us=statistics.median(host), host_us_range=[host[0], host[-1]],
                bound_share=bound / statistics.median(cold))


def cold_launch_ms(torch, make, tensors, out_bytes):
    """Device ms of a prepared kernel launch on a cold L2, as a step finds
    its activations and weights: ``make(*copies)`` prepares one launch (the
    forward's weights packed anew, so they are cold too) for each of as
    many copies of ``tensors`` as ``cold_ms`` would rotate over, and the
    launches rotate inside one CUDA graph. Sorted, one a replay."""
    set_bytes = sum(t.numel() * t.element_size() for t in tensors) + out_bytes
    copies = max(2, min(GRAPH_LAUNCHES, -(-COLD_BYTES // set_bytes) + 1))
    launches = [make(*tensors)] + [make(*(t.clone() for t in tensors))
                                   for _ in range(copies - 1)]
    turn = [0]

    def rotating():
        turn[0] += 1
        return launches[turn[0] % copies]()
    ms = graph_ms(torch, rotating)
    del launches
    return ms


def conv_timings(torch, launcher, wrapper, plain, tensors, out_bytes, library=None, core=None):
    """A bf16 conv kernel's readings, device ms by CUDA-graph replay: the
    kernel alone (``launcher(*tensors)`` prepares its launch; that is the
    record's ms) on a cold L2 and warm; the wrapper, whose preparation (the
    weights' packing; styled_conv's scale, sigma and noise plane) the main
    path pays at every call, cold and warm (``graph_ms``, phase 3's reading
    before these kernels) and its host us a call; the plain twin and the
    yardsticks (``library`` / ``core``: a function and its tensors) cold.
    Every cold reading rotates over copies of all its inputs. ``plain=None``
    leaves the plain twin to the caller."""
    kernel = cold_launch_ms(torch, launcher, tensors, out_bytes)
    warm = graph_ms(torch, launcher(*tensors))
    host = host_us(torch, lambda: wrapper(*tensors))
    out = dict(ms=statistics.median(kernel), ms_range=[kernel[0], kernel[-1]],
               warm_ms=statistics.median(warm),
               wrapper_ms=statistics.median(cold_ms(torch, wrapper, list(tensors))),
               graph_ms=statistics.median(graph_ms(torch, lambda: wrapper(*tensors))),
               host_us=statistics.median(host), host_us_range=[host[0], host[-1]])
    if plain is not None:
        out["plain_ms"] = statistics.median(cold_ms(torch, plain, list(tensors)))
    for key, yardstick in (("library_ms", library), ("conv_core_library_ms", core)):
        if yardstick is not None:
            out[key] = statistics.median(cold_ms(torch, *yardstick))
    return out


def check_kernels(torch, records, floor=None):
    """Every kernel against its plain twin; the records of every case go to
    ``records``. ``floor`` (``launch_floor``'s numbers) goes into each
    timed pixel-update record."""
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
               ops=0, path=None, core=None, fn=None, pixel=None, conv=None, extra_fields=None):
        """``fn``: the kernel's call, for its host us; ``pixel``: a pixel
        update's ``pixel_timings``, whose device ms is the record's ms;
        ``conv``: a bf16 conv kernel's ``conv_timings`` (its ms, plain,
        library and conv-core ms too)."""
        tol = 0.0 if kernel in EXACT else KERNEL_TOL.get((kernel, dtype), TOL[dtype])
        ok = _within(err, rel, tol)
        b, by = bound_ms(nbytes, ops, dtype) if nbytes else (None, None)
        extra = dict(extra_fields or {})
        if pixel is not None:
            extra = {**pixel, **(floor or {})}
            ms = extra.pop("ms")
        elif conv is not None:
            extra.update(conv)
            ms, plain = extra.pop("ms"), extra.pop("plain_ms")
            lib, core = extra.pop("library_ms", None), extra.pop("conv_core_library_ms", None)
        elif fn is not None and ms is not None:
            host = host_us(torch, fn)
            dev = graph_ms(torch, fn)
            extra = dict(host_us=statistics.median(host), host_us_range=[host[0], host[-1]],
                         graph_ms=statistics.median(dev), graph_ms_range=[dev[0], dev[-1]])
        records.append(dict(kernel=kernel, case=case, dtype=dtype, max_abs_err=err,
                            rel_err=rel, tol=tol, ok=ok, ms=ms, plain_ms=plain,
                            library_ms=lib, conv_core_library_ms=core, bound_ms=b,
                            bound_by=by, path=path if ms is not None else None, **extra))
        log(f"  {kernel:14s} {case:22s} {dtype:8s} max_abs_err {err:.3e} "
            f"(rel {rel:.3e}, tol {tol:.0e}) {'ok' if ok else 'FAIL'}"
            + (f"  kernel {ms:.4f} ms plain {plain:.4f} ms bound {b:.4f} ms ({by})"
               if ms is not None else "")
            + (f" library {lib:.4f} ms" if lib is not None else "")
            + (f" conv core (cuDNN) {core:.4f} ms" if core is not None else "")
            + (f" host {extra['host_us']:.2f} us a call, device {extra['graph_ms']:.4f} ms "
               "(graph)" if fn is not None and "graph_ms" in extra and conv is None else ""))
        if conv is not None:
            log(f"    kernel alone: {ms:.4f} ms cold ({extra['ms_range'][0]:.4f}-"
                f"{extra['ms_range'][1]:.4f}), {extra['warm_ms']:.4f} warm, {b / ms:.1%} of the "
                f"bound; wrapper {extra['wrapper_ms']:.4f} cold, {extra['graph_ms']:.4f} warm, "
                f"host {extra['host_us']:.2f} us a call; {extra.get('mma_class', '')} "
                f"[graph replay]")
        if pixel is not None:
            rng, hr, wr = extra["graph_ms_range"], extra["host_us_range"], extra["warm_ms_range"]
            log(f"    device {ms:.4f} ms a launch on a cold L2 ({rng[0]:.4f}-{rng[1]:.4f}, graph "
                f"replay), {extra['bound_share']:.1%} of the bound; warm {extra['warm_ms']:.4f} "
                f"({wr[0]:.4f}-{wr[1]:.4f}); host {extra['host_us']:.2f} us a call "
                f"({hr[0]:.2f}-{hr[1]:.2f}); time_ms {extra['event_ms']:.4f} ms"
                + (f"; floor {extra['floor_ms'] * 1e3:.2f} us device, "
                   f"{extra['floor_host_us']:.2f} us host" if floor else ""))
        if not ok:
            failures.append(f"{kernel} {case} {dtype}: rel err {rel:.3e} > {tol}")

    def check_wgrad(x, g, case, timed, path):
        """The weight grad against its plain version; two launches on the
        same inputs must give the same bits (no atomics, a fixed order).
        Timed bf16 cases read as the forward's (``conv_timings``): the
        kernel alone and its second pass, cold and warm, the wrapper cold
        and warm with its host us, ``conv2d_weight`` cold; the plain twin
        (tens of ms at these shapes) by ``time_ms``."""
        n, h, wd, ch = x.shape
        dtype_name = str(x.dtype).removeprefix("torch.")
        dw = c3.conv3x3_weight_grad_kernel(x, g)
        again = c3.conv3x3_weight_grad_kernel(x, g)
        torch.cuda.synchronize()
        if not torch.equal(dw, again):
            failures.append(f"conv3x3_wgrad {case} {dtype_name}: two launches on the same "
                            f"inputs differ by {(dw - again).abs().max().item():.3e}")
        err, rel = _err(torch, dw, c3.conv3x3_weight_grad_plain(x, g))
        conv = None
        if timed:
            library = (lambda a, b: torch.nn.grad.conv2d_weight(a, (ch, ch, 3, 3), b, padding=1),
                       [x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)])
            conv = conv_timings(torch, c3.conv3x3_weight_grad_launcher,
                                c3.conv3x3_weight_grad_kernel, None, (x, g), 9 * ch * ch * 4,
                                library=library)
            conv["plain_ms"] = time_ms(torch, lambda: c3.conv3x3_weight_grad_plain(x, g))
        cls = c3.WGRAD_CLASSES[ch].name if dtype_name == "bfloat16" else None
        record("conv3x3_wgrad", case, dtype_name, err, rel,
               nbytes=2 * x.numel() * x.element_size() + 9 * ch * ch * 4,
               ops=2 * 9 * ch * ch * n * h * wd, path=path if conv else None, conv=conv,
               extra_fields={"mma_class": cls} if cls else None)

    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        isz = torch.tensor([], dtype=dt).element_size()
        # styled conv: the 9 synthesis shapes, at each path's batch, then
        # the ragged edges of the bf16 kernel's tiles (untimed)
        styled_cases = [(n, res, res, ch, ch, path) for n, path in STYLED_BATCHES.items()
                        for res, ch in STYLED_SHAPES]
        styled_cases += [(n, res, res, ch, ch, fam) for fam, (n, top) in FAMILY_STYLED.items()
                         for res, ch in STYLED_SHAPES if res <= top]
        styled_cases += [(*shape, None) for shape in STYLED_RAGGED]
        for n, h, wd, cin, cout, path in styled_cases:
            x = rn(n, h, wd, cin, dtype=dt)
            w = rn(3, 3, cin, cout, dtype=torch.float32)
            s = rn(n, cin, dtype=torch.float32) * 0.5 + 1.0
            noise = rn(1, h, wd, 1, dtype=torch.float32)
            ns = torch.tensor(0.1, device=dev)
            b = rn(cout, dtype=torch.float32) * 0.1
            args = (x, w, s, noise, ns, b)
            timed = dtype_name == "bfloat16" and path is not None
            case = f"n{n} {h}^2 c{cin}" if (h, cin) == (wd, cout) else \
                f"n{n} {h}x{wd} c{cin}->{cout}"
            views = [("", x)]
            if dtype_name == "bfloat16" and (n, h, wd, cin, cout) == VIEW_OFF["styled"]:
                views.append((" view 2 B off", offset_copy(torch, x, 2)))
            for suffix, xv in views:
                args = (xv, *args[1:])
                y = sc.styled_conv_kernel(*args)
                again = sc.styled_conv_kernel(*args)
                torch.cuda.synchronize()
                if not torch.equal(y, again):
                    failures.append(f"styled_conv {case}{suffix} {dtype_name}: two launches "
                                    "on the same inputs differ")
                err, rel = _err(torch, y, sc.styled_conv_plain(*args))
                cls = c3.mma_class(n, h, wd, cin, cout).name if dtype_name == "bfloat16" else None
                conv = None
                if timed and not suffix:
                    xs = (x * s.to(x.dtype)[:, None, None, :]).permute(0, 3, 1, 2)
                    wn = (w / math.sqrt(9 * cin)).to(x.dtype).permute(3, 2, 0, 1).contiguous(
                        memory_format=torch.channels_last)
                    conv = conv_timings(torch, sc.styled_conv_launcher, sc.styled_conv_kernel,
                                        sc.styled_conv_plain, args, n * h * wd * cout * isz,
                                        core=_conv_core(torch, xs, wn))
                record("styled_conv", case + suffix, dtype_name, err, rel,
                       nbytes=n * h * wd * (cin + cout) * isz + 9 * cin * cout * isz,
                       ops=2 * 9 * cin * cout * n * h * wd, path=path if conv else None,
                       conv=conv, extra_fields={"mma_class": cls} if cls else None)
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
            cls = c3.mma_class(n, h, wd, ch, ch).name if dtype_name == "bfloat16" else None
            wn = w.permute(3, 2, 0, 1).contiguous()
            views = [("", x, g)]
            if dtype_name == "bfloat16" and (n, h, wd, ch) == VIEW_OFF["conv"]:
                views.append((" view 2 B off", offset_copy(torch, x, 2), offset_copy(torch, g, 2)))
            for suffix, xv, gv in views:
                for kernel, wrapper, launcher, plain, inp, lib in (
                        ("conv3x3_fwd", c3.conv3x3_forward_kernel, c3.conv3x3_forward_launcher,
                         c3.conv3x3_plain, xv,
                         (lambda a, k: torch.nn.functional.conv2d(a, k, padding=1),
                          [xv.permute(0, 3, 1, 2), wn])),
                        ("conv3x3_dgrad", c3.conv3x3_input_grad_kernel,
                         c3.conv3x3_input_grad_launcher, c3.conv3x3_input_grad_plain, gv,
                         (lambda a, k: torch.nn.grad.conv2d_input((n, ch, h, wd), k, a, padding=1),
                          [gv.permute(0, 3, 1, 2), wn]))):
                    y = wrapper(inp, w)
                    again = wrapper(inp, w)
                    torch.cuda.synchronize()
                    if not torch.equal(y, again):
                        failures.append(f"{kernel} {case}{suffix} {dtype_name}: two launches on "
                                        "the same inputs differ")
                    err, rel = _err(torch, y, plain(inp, w))
                    conv = (conv_timings(torch, launcher, wrapper, plain, (inp, w), act,
                                         library=lib) if timed and not suffix else None)
                    record(kernel, case + suffix, dtype_name, err, rel,
                           nbytes=2 * act + 9 * ch * ch * isz, ops=ops,
                           path=path if conv else None, conv=conv,
                           extra_fields={"mma_class": cls} if cls else None)

            check_wgrad(x, g, case, timed, path)
        for n, h, wd, ch in WGRAD_RAGGED:
            check_wgrad(rn(n, h, wd, ch, dtype=dt), rn(n, h, wd, ch, dtype=dt),
                        f"n{n} {h}x{wd} c{ch}", False, None)
        # PGD update: the main-path shapes and an odd size, aligned and on
        # views off a 16-byte boundary
        for shape, path in PGD_SHAPES.items():
            adv = rn(*shape, dtype=dt).clamp(-1, 1)
            img = (adv.float() + 0.01 * rn(*shape, dtype=torch.float32)).clamp(-1, 1).to(dt)
            grd = rn(*shape, dtype=dt)
            numel = adv.numel()
            for suffix, (off, off2) in PIXEL_OFFSETS.items():
                views = (offset_copy(torch, adv, off), offset_copy(torch, grd, off2),
                         offset_copy(torch, img, off))
                args = (*views, 0.02, 16 / 255, -1.0, 1.0)
                out = pu.pgd_update_kernel(*args)
                torch.cuda.synchronize()
                err, rel = _err(torch, out, pu.pgd_update_plain(*args))
                timed = dtype_name == "float32" and path is not None and not suffix
                nbytes = 4 * numel * isz
                record("pgd_update", "x".join(map(str, shape)) + suffix, dtype_name, err, rel,
                       plain=time_ms(torch, lambda: pu.pgd_update_plain(*args)) if timed else None,
                       nbytes=nbytes, ops=7 * numel, path=path,
                       pixel=pixel_timings(
                           torch, lambda *t: pu.pgd_update_kernel(*t, *args[3:]), views,
                           bound_ms(nbytes, 7 * numel, dtype_name)[0]) if timed else None)
    # the styled up conv (bf16 only): against the folded composite; timed
    # beside the parent's unfolded chain (transposed conv, blur,
    # demodulation, epilogue) as the plain yardstick
    up_cases = [(n, h, h, cin, cout, path) for n, (path, top) in UP_BATCHES.items()
                for h, cin, cout in UP_SHAPES if 2 * h <= top]
    up_cases += [(*shape, None) for shape in UP_RAGGED]
    for n, h, wd, cin, cout, path in up_cases:
        x = rn(n, h, wd, cin, dtype=torch.bfloat16)
        args = (x, rn(3, 3, cin, cout, dtype=torch.float32),
                rn(n, cin, dtype=torch.float32) * 0.5 + 1.0,
                rn(1, 2 * h, 2 * wd, 1, dtype=torch.float32), torch.tensor(0.1, device=dev),
                rn(cout, dtype=torch.float32) * 0.1)
        case = f"n{n} {h}^2 c{cin}->{cout}" if h == wd else f"n{n} {h}x{wd} c{cin}->{cout}"
        y = sc.styled_conv_up_kernel(*args)
        again = sc.styled_conv_up_kernel(*args)
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            failures.append(f"styled_conv_up {case}: two launches on the same inputs differ")
        err, rel = _err(torch, y, sc.styled_conv_up_reference(*args))
        y_bytes = n * 4 * h * wd * cout * 2
        conv = (conv_timings(torch, sc.styled_conv_up_launcher, sc.styled_conv_up_kernel,
                             sc.styled_conv_up_plain, args, y_bytes)
                if path is not None else None)
        extra = {"mma_class": c3.mma_class(n, h, wd, cin, 4 * cout).name}
        if conv is not None:  # the folded composite, the route of what the kernel does not take
            extra["composite_ms"] = statistics.median(
                cold_ms(torch, sc.styled_conv_up_reference, list(args)))
        record("styled_conv_up", case, "bfloat16", err, rel,
               nbytes=n * h * wd * cin * 2 + y_bytes + 9 * cin * 4 * cout * 2,
               ops=2 * 9 * cin * 4 * cout * n * h * wd, path=path, conv=conv,
               extra_fields=extra)
        if conv is not None:
            log(f"    folded composite {extra['composite_ms']:.4f} ms cold [graph replay]")
    # the styled convs' backward (bf16: K1 + K2, csrc/styled_conv.cu) against
    # its plain twin, twice: with the bias at +8 / -8 on alternate channels,
    # so that no pre-activation z lies within a rounding of the leaky ReLU's
    # kink (where the gradient jumps and the twin's float32 sums, in another
    # order, may fall on the other side), and with a synthesis's bias (0.1
    # randn), z near the kink at some pixels, the twin taking the sign of z
    # from the forward kernel's own y (K1 re-runs the forward's conv and
    # epilogue arithmetic, so its z is the forward's): a K1 that leaves out
    # the noise, reads another pixel's or phase's, or leaves out sigma flips
    # signs there. Two launches bit-equal; timed once: the pair alone
    # (prepared: the kernels and the partials' sums) and wrapped (the
    # weights folded and packed twice, sigma, the noise plane), beside the
    # recomputed composite it replaces (autograd of styled_conv_reference /
    # styled_conv_up_reference with respect to x and the style)
    bwd_cases = [(n, h, h, cin, cout, kind == "up", path)
                 for n, (path, top) in UP_BATCHES.items()
                 for kind, h, cin, cout in BWD_SHAPES if (2 * h if kind == "up" else h) <= top]
    bwd_cases += [(*shape, None) for shape in BWD_RAGGED]
    for n, h, wd, cin, cout, up, path in bwd_cases:
        oh, ow = (2 * h, 2 * wd) if up else (h, wd)
        x, w, s, noise = (rn(n, h, wd, cin, dtype=torch.bfloat16),
                          rn(3, 3, cin, cout, dtype=torch.float32),
                          rn(n, cin, dtype=torch.float32) * 0.5 + 1.0,
                          rn(1, oh, ow, 1, dtype=torch.float32))
        ns, g = torch.tensor(0.1, device=dev), rn(n, oh, ow, cout, dtype=torch.bfloat16)
        kernel = "styled_conv_up_bwd" if up else "styled_conv_bwd"
        forward = sc.styled_conv_up_kernel if up else sc.styled_conv_kernel
        cg = 4 * cout if up else cout
        launcher = functools.partial(sc.styled_conv_backward_launcher, up=up)
        wrapper = functools.partial(sc.styled_conv_backward_kernel, up=up)
        for synthesis in (False, True):
            bias = (rn(cout, dtype=torch.float32) * 0.1 if synthesis
                    else 8.0 * (1 - 2 * (torch.arange(cout, device=dev) % 2)).float())
            args = (x, w, s, noise, ns, bias, g)
            case = f"n{n} {h}^2 c{cin}->{cout}" if h == wd else f"n{n} {h}x{wd} c{cin}->{cout}"
            case += " synth bias" if synthesis else ""
            got, again = wrapper(*args), wrapper(*args)
            positive = forward(*args[:6]) > 0 if synthesis else None
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                failures.append(f"{kernel} {case}: two launches on the same inputs differ")
            want = sc.styled_conv_backward_plain(*args, up=up, positive=positive)
            errs = [_err(torch, a, b) for a, b in zip(got, want)]
            err, rel = max(e for e, _ in errs), max(r for _, r in errs)
            timed = path if not synthesis else None
            conv, extra = None, {"mma_class": "+".join(
                (c3.mma_class(n, h, wd, cin, cg).name, c3.mma_class(n, h, wd, cg, cin).name))}
            # the function reads x and g and writes gx; the design also
            # writes gc and reads it back and reads x twice (K1, K2): its
            # bound beside the function's
            design = 2 * n * h * wd * 3 * (cin + cg) + 2 * 9 * cin * cg * 2
            ops = 4 * 9 * cin * cg * n * h * wd  # twice the forward's
            if timed is not None:
                conv = conv_timings(torch, launcher, wrapper, None, args, n * h * wd * cin * 2)
                conv["plain_ms"] = statistics.median(cold_ms(
                    torch, lambda *t: sc.styled_conv_backward_plain(*t, up=up), list(args)))
                reference = sc.styled_conv_up_reference if up else sc.styled_conv_reference

                def composite(x, w, s, noise, ns, b, g):
                    with torch.enable_grad():
                        xi, si = x.detach().requires_grad_(), s.detach().requires_grad_()
                        return torch.autograd.grad(reference(xi, w, si, noise, ns, b), (xi, si),
                                                   g)
                extra["composite_ms"] = statistics.median(cold_ms(torch, composite, list(args)))
                extra["design_bound_ms"] = bound_ms(design, ops, "bfloat16")[0]
            record(kernel, case, "bfloat16", err, rel,
                   nbytes=2 * n * h * wd * (2 * cin + cg) + 9 * cin * cg * 2,
                   ops=ops, path=timed, conv=conv, extra_fields=extra)
            if conv is not None:
                log(f"    recomputed composite {extra['composite_ms']:.4f} ms cold [graph replay];"
                    f" the design's bound (gc written and read, x twice) "
                    f"{extra['design_bound_ms']:.4f} ms")
    # fused Adam (float32 only): the white-box pixel buffer and an odd size,
    # aligned and on views off a 16-byte boundary, at steps 1 and 50
    for shape, path in ADAM_SHAPES.items():
        for count in (1, 50):
            bc1, bc2 = au.bias_corrections(count)
            # the kernel reads them from the device's table, row count - 1
            table, step = au.bias_table("cuda"), au.step_index("cuda", count - 1)
            state = [rn(*shape, dtype=torch.float32) for _ in range(4)]
            state[2] *= 0.1
            state[3] = state[3].square() * 0.01
            for suffix, (off, off2) in PIXEL_OFFSETS.items():
                x, g, mu, nu = (offset_copy(torch, t, off2 if i == 1 else off)
                                for i, t in enumerate(state))
                want = au.adam_update_plain(x.clone(), g, mu.clone(), nu.clone(), 1e-4,
                                            bc1, bc2)
                au.adam_update_kernel(x, g, mu, nu, 1e-4, table, step)
                torch.cuda.synchronize()
                err = max(_err(torch, a, b)[0] for a, b in zip((x, mu, nu), want))
                timed = path is not None and count == 1 and not suffix
                numel = x.numel()
                case = "x".join(map(str, shape)) + f" t{count}" + suffix
                record("fused_adam", case, "float32", err, err,
                       plain=time_ms(torch, lambda: au.adam_update_plain(
                           x, g, mu, nu, 1e-4, bc1, bc2)) if timed else None,
                       lib=_torch_adam_ms(torch, x, g) if timed else None,
                       nbytes=7 * numel * 4 + 12, ops=12 * numel,
                       path=path if timed else None,
                       pixel=pixel_timings(
                           torch, lambda *t: au.adam_update_kernel(*t, 1e-4, table, step),
                           (x, g, mu, nu),
                           bound_ms(7 * numel * 4 + 12, 12 * numel, "float32")[0])
                       if timed else None)
    torch.backends.cudnn.allow_tf32 = True
    if failures:
        fail("kernel disagrees with its plain version: " + "; ".join(failures))


def _conv_core(torch, xs, wn):
    """The cuDNN yardstick for styled_conv's conv core: ``F.conv2d`` of the
    modulated input ``xs`` (bf16, channels-last) with the scaled weights
    ``wn``, without the demodulation / noise / bias / activation epilogue,
    so it is kept apart from ``library_ms`` (timed only; the port never
    calls it): the function and its tensors, for ``cold_ms``."""
    return (lambda a, k: torch.nn.functional.conv2d(a, k, padding=1), [xs, wn])


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
        # the host us a call, and a pixel update's time_ms reading and
        # launch floor, summed over the same shapes
        **{key: sum(r[key] for r in timed) for key in ("host_us", "event_ms", "warm_ms",
                                                       "graph_ms", "wrapper_ms")
           if all(key in r for r in timed)},
        **{key: timed[0][key] for key in ("floor_ms", "floor_host_us") if key in timed[0]},
        "shapes_timed": [f"{r['case']} {r['dtype']}" for r in timed],
    }


def summarize(records, runs):
    """One entry per kernel source: launches on the main paths and
    ``_numbers``. ``runs`` maps each main path ("pgd", "whitebox",
    "spatial", "patch", "classifier", "cli", phase 5g's "sharded",
    "resume" and "export", and phase 5h's "car" and "church", whose per
    step counts are an arithmetic PGD step's) to its (launch counts,
    launches per step; per
    inner step on the patch path; None for a run that has no one step);
    ``launches`` is their sum, each graph replay at its measured counts
    (``LaunchAudit``). The numbers at the top of an entry are those of the kernel's
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
            if per_step is not None:
                out[f"launches_per_{path}_step"] = sum(per_step[k] for k in keys)
        return out

    def entry(name, source, replaces, keys, home="pgd"):
        return {"name": name, "route": "cuda", "source": f"tpufusion_torch/csrc/{source}",
                "replaces": replaces, **launches(keys), **numbers(keys, home)}

    pallas_conv = "tpufusion/ops/pallas_conv.py"
    # each part: its records' kernel, the TPU kernel it replaces, its bf16
    # CUDA kernel
    parts = {
        "forward": ("conv3x3_fwd", f"{pallas_conv}:195", "conv3x3_wgmma_kernel"),
        "input_grad": ("conv3x3_dgrad", f"{pallas_conv}:195", "conv3x3_wgmma_kernel"),
        "weight_grad": ("conv3x3_wgrad", f"{pallas_conv}:284", "conv3x3_wgrad_wgmma_kernel"),
    }
    conv3x3 = entry("conv3x3", "conv3x3.cu", f"{pallas_conv}:195",
                    ("conv3x3_fwd", "conv3x3_dgrad"))
    conv3x3["launches"] = sum(runs[p][0][k] for p in runs for k, _, _ in parts.values())
    conv3x3["parts"] = {part: {"kernel": kern, "replaces": rep, **launches((k,)),
                               **numbers((k,), "pgd")}
                        for part, (k, rep, kern) in parts.items()}
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
    from tpufusion_torch.ops import launch_counts
    from tpufusion_torch.ops import styled_conv as sc

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(30)

    def wgrad_launches():
        return launch_counts()["conv3x3_wgrad"]

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
            before = wgrad_launches()
            (dw,) = torch.autograd.grad(fn(x, w, *rest), w, g)
            torch.cuda.synchronize()
            grads.append((dw, wgrad_launches() - before))
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
    before = wgrad_launches()
    image = model([z]).image
    image.backward(torch.randn(image.shape, generator=gen, device=dev))
    torch.cuda.synchronize()
    launched = wgrad_launches() - before
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
    check_family_small(torch)
    check_patch_lpips_legacy(torch, cpu, gpu, x, t)
    check_classifier_small(torch, gpu)
    torch.backends.cudnn.allow_tf32 = True


def check_family_small(torch):
    """Phase 5h's families at 32^2, card against CPU on the same weights:
    the spatial fused image of N role inputs (car 4, church 3: the roles
    reconstructed body first) and the pixel and 'vgg' objectives'
    gradients, as ``check_fusion_card_vs_cpu`` holds FFHQ's."""
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.pipeline import FusionPipeline

    for fam, (n, _) in FAMILY_STYLED.items():
        cpu = FusionPipeline.create(fam, device="cpu", policy=Policy(), **SMALL_PIPELINE)
        gpu = FusionPipeline.create(fam, device="cuda", policy=Policy(), **SMALL_PIPELINE)
        for name in ("generator", "encoder", "vgg"):
            getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
        gpu.drawer.blender.load_state_dict(cpu.drawer.blender.state_dict())
        gpu.latent_avg = cpu.latent_avg.cuda()
        gen = torch.Generator().manual_seed(SMALL_SPATIAL_SEED)
        x = torch.rand((n, 32, 32, 3), generator=gen) * 2 - 1
        t = torch.rand((1, 32, 32, 3), generator=gen) * 2 - 1
        log(f"  small reference: {fam}, N={n}")
        check_fusion_card_vs_cpu(torch, cpu, gpu, x, t, "spatial")


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
# the attack loops' step programs: graph replays against the eager twins
# ---------------------------------------------------------------------------

# Every attack step runs on its program (tpufusion_torch/core/graphs.py):
# its first step eager, every later one a CUDA graph replay. With
# deterministic algorithms required, the graph and its eager twin
# (pgd_eager, whitebox.run_eager, cw_eager) from the same start give the
# same bits: the fusion PGD and white-box steps are held bit-equal. Under
# the default flags two eager runs of 100 PGD steps already differ by up
# to 2 eps (a sign step flipped by the atomics, the runs parting after it).
# Classifier PGD and CW go through the antialiased resize, whose backward
# is the port's own (core/imaging.py::_Resize: PyTorch's accumulates with
# atomics and parted the graph from its twin by 0.13 on the card): held
# within 1e-6, as phase 5g holds CW.
GRAPH_ATOL = {"fusion": 0.0, "classifier": 1e-6}
HOST_REPLAYS = 5  # replays timed one at a time for the host us a replay

# each KERNEL_NAMES group -> the launch count of the wrapper that launches
# its kernel; the conv3x3 forward and input grad share one kernel, and so
# do both styled backwards' K2, so the profiler sees their sums
GROUP_COUNTS = {"styled_conv bf16": "styled_conv", "styled_conv fp32": "styled_conv",
                "styled_conv_up bf16": "styled_conv_up",
                "styled_conv_bwd K1": "styled_conv_bwd",
                "styled_conv_up_bwd K1": "styled_conv_up_bwd",
                "styled_conv backward K2": "styled_conv_bwd+up_bwd",
                "conv3x3_fwd/dgrad bf16": "conv3x3_fwd+dgrad",
                "conv3x3_fwd/dgrad fp32": "conv3x3_fwd+dgrad",
                "conv3x3_wgrad bf16": "conv3x3_wgrad", "conv3x3_wgrad fp32": "conv3x3_wgrad",
                "pgd_update": "pgd_update", "fused_adam": "fused_adam"}
AUDITED = ("styled_conv", "styled_conv_up", "conv3x3_fwd+dgrad", "conv3x3_wgrad", "pgd_update",
           "fused_adam", "styled_conv_bwd", "styled_conv_up_bwd", "styled_conv_bwd+up_bwd")


def audited_counts(counts):
    """``launch_counts``-keyed counts as the profiler can tell them apart
    (``AUDITED`` keys)."""
    return {"styled_conv": counts.get("styled_conv", 0),
            "styled_conv_up": counts.get("styled_conv_up", 0),
            "conv3x3_fwd+dgrad": counts.get("conv3x3_fwd", 0) + counts.get("conv3x3_dgrad", 0),
            "conv3x3_wgrad": counts.get("conv3x3_wgrad", 0),
            "pgd_update": counts.get("pgd_update", 0), "fused_adam": counts.get("fused_adam", 0),
            "styled_conv_bwd": counts.get("styled_conv_bwd", 0),
            "styled_conv_up_bwd": counts.get("styled_conv_up_bwd", 0),
            "styled_conv_bwd+up_bwd": (counts.get("styled_conv_bwd", 0)
                                       + counts.get("styled_conv_up_bwd", 0))}


def kernel_counts(rows):
    """The launches of each wrapper's kernel among a profile's ``(kernel,
    ms, calls)`` rows (``_device_rows``), ``AUDITED``-keyed."""
    out = dict.fromkeys(AUDITED, 0)
    for key, _, count in rows:
        group = next((g for pat, g in KERNEL_NAMES if pat in key), None)
        if group in GROUP_COUNTS:
            out[GROUP_COUNTS[group]] += count
    return out


def replay_count_failures(what, measured, booked):
    """A replay's kernel launches as the profiler saw them against those its
    program adds to the counts (``StepProgram.launches``)."""
    return [f"{what}: the profiler saw a replay launch {k} {measured[k]} times, the program "
            f"counts {booked[k]}" for k in AUDITED if measured[k] != booked[k]]


def _profiling(torch):
    return bool(torch.autograd.profiler._is_profiler_enabled)


class LaunchAudit:
    """What the step programs' graph replays launch, measured. A wrapper
    counts a launch when its Python runs, which a replay does not: a
    program adds the launches that its capture counted at each replay
    (``StepProgram.launches``; booked here). Installed over
    ``StepProgram.run``, the audit runs the first replay of every program
    under torch.profiler and counts the rows of each wrapper's kernel
    (``kernel_counts``); a count that differs from the booked one fails the
    run. ``read()`` gives the launch counts since ``reset()`` with every
    replay at its program's measured counts, and fails if a replay in that
    run was never measured. Inside ``paused()`` (a timed call) nothing is
    profiled: the replays wait for ``measure(prog)``, or with
    ``track=False`` (outside the counted runs) are not followed at all.
    ``seconds`` is the time spent in the profiled replays."""

    def __init__(self, torch):
        import weakref

        self.torch = torch
        self.per_replay = weakref.WeakKeyDictionary()  # program -> its measured replay
        self.orig = None
        self.hold = self.untracked_mode = self.audited = 0
        self.seconds = 0.0
        self._zero()

    def _zero(self):
        self.booked = dict.fromkeys(AUDITED, 0)
        self.measured = dict.fromkeys(AUDITED, 0)
        self.pending: dict = {}  # program -> its replays not measured yet
        self.untracked = 0

    def install(self):
        from tpufusion_torch.core.graphs import StepProgram

        self.orig = StepProgram.run
        StepProgram.run = lambda prog, n=1: self.run(prog, n)
        return self

    def uninstall(self):
        from tpufusion_torch.core.graphs import StepProgram

        StepProgram.run = self.orig

    @contextlib.contextmanager
    def paused(self, track=True):
        self.hold += 1
        self.untracked_mode += not track
        try:
            yield
        finally:
            self.hold -= 1
            self.untracked_mode -= not track

    def run(self, prog, n):
        if prog.device.type != "cuda":
            return self.orig(prog, n)
        warm = min(n, prog.warm_left)
        if warm:
            self.orig(prog, warm)
            n -= warm
        if n and prog not in self.per_replay and not self.hold and not _profiling(self.torch):
            self._measure(prog)
            n -= 1
        if n:
            self.orig(prog, n)
            self._book(prog, n)
            self._credit(prog, n)

    def _book(self, prog, n):
        for k, v in audited_counts(prog.launches).items():
            self.booked[k] += v * n

    def _credit(self, prog, n):
        got = self.per_replay.get(prog)
        if got is not None:
            for k in AUDITED:
                self.measured[k] += got[k] * n
        elif self.untracked_mode:
            self.untracked += n
        else:
            self.pending[prog] = self.pending.get(prog, 0) + n

    def _profile_replay(self, prog):
        """One replay of ``prog`` under torch.profiler: its kernel rows."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        torch.cuda.synchronize()
        pad = torch.zeros(1, device=prog.device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):  # a launch right after the start can go missing
                pad.add_(1)
            torch.cuda.synchronize()
            self.orig(prog, 1)
            torch.cuda.synchronize()
        return _device_rows(prof)

    def _measure(self, prog):
        prog.capture()
        t0 = time.perf_counter()
        got = kernel_counts(self._profile_replay(prog))
        self.seconds += time.perf_counter() - t0
        self.audited += 1
        short = replay_count_failures("a step program", got, audited_counts(prog.launches))
        if short:
            fail("; ".join(short))
        self.per_replay[prog] = got
        self._book(prog, 1)
        self._credit(prog, 1 + self.pending.pop(prog, 0))

    def measure(self, prog) -> int:
        """Profile one more replay of ``prog`` (a captured program not
        measured yet; a loaded state that has taken its steps is
        ``rewind``-ed first). Returns the replays it made, 0 or 1."""
        if prog.graph is None or prog in self.per_replay:
            return 0
        if prog.taken >= prog.limit:
            rewind(prog)
        self._measure(prog)
        return 1

    def replay_counts(self, prog):
        """One replay of ``prog`` by ``launch_counts`` key: measured, the
        forward and input grad split as the capture counted them (their
        sum measured)."""
        got = self.per_replay[prog]
        return dict(prog.launches, styled_conv=got["styled_conv"],
                    styled_conv_up=got["styled_conv_up"], conv3x3_wgrad=got["conv3x3_wgrad"], pgd_update=got["pgd_update"],
                    fused_adam=got["fused_adam"])

    def reset(self):
        from tpufusion_torch import ops

        ops.reset_launch_counts()
        self._zero()

    def read(self):
        from tpufusion_torch import ops

        if self.pending or self.untracked:
            fail(f"{sum(self.pending.values()) + self.untracked} replays in a counted run "
                 f"were never measured")
        counts = ops.launch_counts()
        out = dict(counts)
        for k in ("styled_conv", "styled_conv_up", "conv3x3_wgrad", "pgd_update", "fused_adam"):
            out[k] = counts[k] - self.booked[k] + self.measured[k]
        return out


AUDIT = None  # the LaunchAudit of phases 4 on (main installs it)


def reset_counts():
    """Every launch count to 0: the start of a counted run."""
    from tpufusion_torch import ops

    (AUDIT.reset if AUDIT is not None else ops.reset_launch_counts)()


def read_counts():
    """The launch counts since ``reset_counts``, the replays' measured."""
    from tpufusion_torch import ops

    return AUDIT.read() if AUDIT is not None else ops.launch_counts()


def audit_paused(track=True):
    return AUDIT.paused(track) if AUDIT is not None else contextlib.nullcontext()


@contextlib.contextmanager
def uncounted():
    """The launches inside the block (a comparison with an eager twin, not
    the main path) leave the counts as they were."""
    from tpufusion_torch import ops

    saved = ops.launch_counts()
    books = None if AUDIT is None else (dict(AUDIT.booked), dict(AUDIT.measured),
                                        dict(AUDIT.pending), AUDIT.untracked)
    try:
        yield
    finally:
        ops.reset_launch_counts()
        ops.add_launch_counts(saved)
        if books is not None:
            AUDIT.booked, AUDIT.measured, AUDIT.pending, AUDIT.untracked = books


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (warnings only; cuBLAS's workspace fixed) inside the block, the flags
    restored after it."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def rewind(prog):
    """Load ``prog``'s end state again with every step counter (the integer
    tensors) at 0, so that it takes its steps once more."""
    from tpufusion_torch.core.graphs import map_tensors, static_copy

    prog.load(map_tensors(lambda t: t if t.is_floating_point() else t.zero_(),
                          static_copy(prog.state)), prog.inputs)


def replay_step(prog):
    """One replay of ``prog``, as a function for the profiler (rewound
    whenever its loaded state has taken its steps)."""
    def run():
        if prog.taken >= prog.limit:
            rewind(prog)
        prog.run(1)
    return run


def replay_host_us(torch, prog, reps=HOST_REPLAYS):
    """Host us of one replay with the card idle before it (the
    ``graph.replay()`` call alone: no synchronize inside), the least of
    ``reps``."""
    out = []
    for _ in range(reps):
        if prog.taken >= prog.limit:
            rewind(prog)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.run(1)
        out.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    return min(out)


def graphed_timing(torch, call, attack, steps, *, eager=None, what="", atol=0.0):
    """``call()`` twice on one attack object, from the same start each
    time, under the default flags, with the launch audit paused: the first
    call, on new programs, timed (``first_call_ms``: the programs' first
    steps eager, their captures, the replays after them), the second,
    replays only, timed (``step_ms``, over ``steps``), then the host us of
    a replay; then one more replay of each program measured
    (``LaunchAudit.measure``), which settles the earlier replays. No
    profiler runs between a capture and the timed replays: a graph's
    replays right after a profiler session cost more (PERF.md §5). The
    peak memory spans both calls. Returns ``(result, numbers)``: also
    ``capture_ms`` (the programs' sum), ``host_us`` a replay, ``peak_gib``,
    ``per_replay`` (each kernel's launches in one replay as the profiler
    counted them, summed over the programs), ``counts`` (the second call's
    launches), ``steps`` (every step it took: both calls, the measured
    replays, ``host_us``'s) and ``hold``: a function that holds the same
    attack object's graphs to ``eager()``, their eager twin from the same
    start (``hold_timed_graph``), to be called outside the counted run and
    before the attack's programs are freed."""
    from tpufusion_torch import ops

    from tpufusion_torch.ops import launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with audit_paused():
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        before = launch_counts()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        booked = _diff(launch_counts(), before)
        host_us = replay_host_us(torch, list(attack.programs)[0])
    # a replay allocates nothing: the step's activations were allocated
    # from the graph's pool at capture, so the peak spans both calls
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    progs = list(attack.programs)
    extra = sum(AUDIT.measure(p) for p in progs) if AUDIT is not None else 0
    per_replay = dict.fromkeys(ops.launch_counts(), 0)
    for prog in progs:
        # measured on the card; a program that never captured replays nothing
        one = (AUDIT.replay_counts(prog) if AUDIT is not None and prog.graph is not None
               else prog.launches)
        for k, v in one.items():
            per_replay[k] += v
    # the second call's launches, its replays at their measured counts (its
    # eager work, a white-box call's reference bundle, as the wrappers count)
    replay_booked = {k: sum(p.launches.get(k, 0) for p in progs if p.graph is not None) * steps
                     for k in booked}
    counts = {k: booked[k] - replay_booked[k] + per_replay[k] * steps for k in booked}
    numbers = dict(step_ms=ms / steps, first_call_ms=first_ms, calls_steps=steps,
                   capture_ms=sum(p.capture_ms for p in progs),
                   host_us=host_us, peak_gib=peak,
                   per_replay=per_replay, counts=counts, steps=2 * steps + extra + HOST_REPLAYS)
    numbers["hold"] = lambda: hold_timed_graph(torch, what, call, eager, steps, atol=atol)
    return out, numbers


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _as_tensor(torch, a):
    import numpy as np

    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def graph_failures(torch, what, got, want, *, atol=0.0):
    """``(max |got - want|, failures)`` over the tensor and array leaves of
    a graphed run's result and its eager twin's (``held_failures`` each)."""
    worst, out = 0.0, []
    a, b = _leaves(got), _leaves(want)
    if len(a) != len(b):
        return math.inf, [f"{what}: {len(a)} results against the eager twin's {len(b)}"]
    for i, (u, v) in enumerate(zip(a, b)):
        err, fails = held_failures(torch, f"{what} (result {i})", _as_tensor(torch, u),
                                   _as_tensor(torch, v), atol=atol)
        worst = max(worst, err)
        out += fails
    return worst, [f.replace("single-device route", "eager twin") for f in out]


def hold_timed_graph(torch, what, call, eager, steps, *, atol=0.0):
    """The timed attack object held to ``eager()``, its eager twin from the
    same start. Under the default flags two eager runs already differ (the
    atomics of e4e's bilinear backward flip a sign step, and the runs
    part), so the hold is made under
    ``deterministic``: ``call()`` on the same attack object captures new
    programs for these flags (its cache keys on them), the first call; the
    second, replays only, is timed (``det_step_ms``) and held to the twin
    with ``graph_failures``, which fails the run on a mismatch. The twin's
    call is timed too. Returns ``dict(err, det_step_ms, eager_call_ms,
    eager_per_step)``: the max |err|, the ms and the twin's launches a
    step."""
    from tpufusion_torch import ops

    with deterministic(torch):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        det_ms = (time.perf_counter() - t0) * 1e3
        before = ops.launch_counts()
        t0 = time.perf_counter()
        want = eager()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        after = ops.launch_counts()
    err, fails = graph_failures(torch, what, got, want, atol=atol)
    if fails:
        fail("; ".join(fails))
    per_step = {k: (after[k] - before[k]) / steps for k in after}
    log(f"  {what}: the attack's graphs against the eager twin, deterministic: max_abs_err "
        f"{err:.3e} (tol {atol:g}); replays {det_ms / steps:.3f} ms a step, the twin "
        f"{eager_ms / steps:.3f}; the twin's launches a step {per_step}")
    return dict(err=err, det_step_ms=det_ms / steps, eager_call_ms=eager_ms,
                eager_per_step=per_step)


def replay_launch_failures(what, per_replay, eager_per_step):
    """A graph replay launches each kernel as often as an eager step does."""
    return [f"{what}: a replay launches {k} {per_replay.get(k, 0)} times, an eager step "
            f"{v}" for k, v in eager_per_step.items() if per_replay.get(k, 0) != v]


def hold_graphs(what, g, hold):
    """Fail the run unless a replay launches what an eager step does."""
    short = replay_launch_failures(what, g["per_replay"], hold["eager_per_step"])
    if short:
        fail("; ".join(short))


def log_graph(card, what, g):
    log(f"  {what}: first call {g['first_call_ms']:.1f} ms (its capture {g['capture_ms']:.1f}), "
        f"host_us a replay {g['host_us']:.1f}, peak_gib {g['peak_gib']:.3f} [{card}]; a replay "
        f"launches (the profiler's count) {g['per_replay']}")


def graph_numbers(prefix, g, hold=None):
    """The numbers of one graphed attack (``graphed_timing``) and of its
    timed graph's hold (``hold_timed_graph``), named ``<prefix>_...``."""
    out = {f"{prefix}_capture_ms": g["capture_ms"], f"{prefix}_first_call_ms": g["first_call_ms"],
           f"{prefix}_host_us_per_replay": g["host_us"]}
    if hold is not None:
        out.update({f"{prefix}_graph_vs_eager": hold["err"],
                    f"{prefix}_deterministic_step_ms": hold["det_step_ms"],
                    f"{prefix}_deterministic_eager_step_ms":
                        hold["eager_call_ms"] / g["calls_steps"]})
        log(f"  {prefix}: a call on a new attack {g['first_call_ms']:.3f} ms (first step eager, "
            f"capture, replays), the second call {g['step_ms'] * g['calls_steps']:.3f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

# the full-width FFHQ pipeline of phases 5-6: config-f generator, e4e
# IR-SE-50, seeded random weights
FULL_PIPELINE = dict(size=1024, channel_multiplier=2, encoder_base_channels=64,
                     encoder_units=(3, 4, 14, 3), encoder_input_size=256, seed=0)


def run_main_path(torch, card):
    """The fusion attack (arithmetic, pixel objective) on N = 2 1024^2
    inputs: a warm-up forward and step, then with the launch counts set to
    0: three timed fused forwards, FGSM and a 5-step PGD attack called
    twice from one start (``graphed_timing``: the first call captures its
    step, the second is timed); then, outside the counted run, the timed
    graph held to its eager twin under the same flags and a new graph held
    bit-equal to it under ``deterministic``."""
    from tpufusion_torch import ops
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, fgsm_on_fusion, make_fused_image_fn, make_fusion_attack,
        make_fusion_loss)
    from tpufusion_torch.attacks.pgd import pgd_eager, pgd_random_start
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

    pc = dataclasses.replace(pgd_cfg.pgd, targeted=pgd_cfg.targeted)

    def seeded():
        return torch.Generator(device="cuda").manual_seed(11)

    def eager():
        return pgd_eager(make_fusion_loss(pipe, pgd_cfg), pc, inputs,
                         pgd_random_start(inputs, seeded(), pc), target)

    reset_counts()
    n_fwd = 3
    with torch.no_grad():
        t0 = time.perf_counter()
        for _ in range(n_fwd):
            fused = fused_fn(inputs)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3 / n_fwd
    fwd_launches = read_counts()["styled_conv"]
    adv1, tr1 = fgsm_on_fusion(pipe)(inputs, target)
    attack = make_fusion_attack(pipe, pgd_cfg)
    before_pgd = read_counts()
    (adv, trace), g = graphed_timing(torch, lambda: attack(inputs, target, seeded()), attack,
                                     pgd_cfg.pgd.steps, eager=eager, what="fusion PGD")
    launches = read_counts()
    per_step = dict(g["per_replay"])
    step_ms, peak_gib = g["step_ms"], g["peak_gib"]
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
    per_fwd, n_up = family_expectations(pipe.generator.conv_plan())  # 9 and 8 at 1024^2
    need = {"styled_conv": per_fwd * (n_fwd + steps), "styled_conv_bwd": per_fwd * steps,
            "styled_conv_up_bwd": n_up * steps, "pgd_update": steps}
    for name, n_min in need.items():
        if launches[name] < n_min:
            fail(f"main path launched {name} {launches[name]} times, expected >= {n_min}")
    if launches["styled_conv_bwd_composite"]:
        fail(f"main path recomputed the styled composite "
             f"{launches['styled_conv_bwd_composite']} times, expected 0")
    if fwd_launches != per_fwd * n_fwd:
        fail(f"{n_fwd} fused forwards launched styled_conv {fwd_launches} times, "
             f"expected {per_fwd * n_fwd}")
    timed = {k: (launches[k] - before_pgd[k]) for k in launches}
    log(f"  fused_forward_ms {fwd_ms:.3f} [{card}] (mean of {n_fwd})")
    log(f"  pgd_step_ms {step_ms:.3f} [{card}] (N=2 inputs, 1024^2, bf16, 5 steps: graph "
        f"replays of the captured step, the second call of one attack)")
    log_graph(card, "pgd", g)
    log(f"  peak_memory_gib {peak_gib:.3f} [{card}]")
    log(f"  loss trace {trace} -> final {final_loss:.6f}; fgsm loss {tr1.item():.6f}")
    log(f"  launches {launches} ({n_fwd} fused forwards: styled_conv {fwd_launches}; "
        f"per PGD step {per_step}; the PGD calls of graphed_timing {timed})")

    timed_hold = g["hold"]()
    attack.programs.release()
    hold_graphs("fusion PGD", g, timed_hold)
    release_cache(torch)
    return launches, per_step, dict(fused_forward_ms=fwd_ms, pgd_step_ms=step_ms,
                                    **graph_numbers("pgd", g, timed_hold),
                                    peak_memory_gib=peak_gib, loss_trace=trace,
                                    final_loss=final_loss), \
        (pipe, cfg, inputs, target, gen)


# ---------------------------------------------------------------------------
# --first-calls: what a user's call costs on a new attack object
# ---------------------------------------------------------------------------

FIRST_CALL_N = 5  # the ffhq fusion roles; configs/ffhq_whitebox.json's N
# steps: R+FGSM's one; AttackRunConfig's pgd_steps (100) for pgd and
# fusion_pgd_arith; ITER_DICT at 1024^2 (100) for white_box_target
FIRST_CALL_STEPS = {"fgsm": 1, "pgd": 100, "fusion_pgd_arith": 100, "white_box_target": 100}


def _wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def run_first_calls(torch, card):
    """Each attack that the runner dispatches, at FFHQ 1024^2 on N = 5
    inputs at its config's step count (``FIRST_CALL_STEPS``): a call on a
    new attack object (``first_ms``: its program's first step eager, the
    capture, the replays), a second call on it (``second_ms``: replays
    only) and the eager twin from the same start (``eager_ms``), after a
    1-step warm-up of each; host clock around a synchronize. R+FGSM and PGD
    on the runner's encoder-drift objective (``fgsm``, ``pgd``), fusion
    PGD (``fusion_pgd_arith``) and the per-image white-box attack
    (``white_box_target``, its reference bundle included). The flags are
    the production ones (phases 5-5h hold the graphs to their twins under
    ``deterministic``): the results are only checked finite."""
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, make_fusion_attack, make_fusion_loss)
    from tpufusion_torch.attacks.pgd import PGDConfig, make_pgd, pgd_eager, pgd_random_start
    from tpufusion_torch.attacks.whitebox import (
        PRESET_ATTACK_MAIN, WhiteboxConfig, make_per_image_whitebox, run_eager)
    from tpufusion_torch.core.imaging import avg_pool
    from tpufusion_torch.pipeline import FusionPipeline

    pipe = FusionPipeline.create("ffhq", device="cuda", **FULL_PIPELINE)
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.rand((FIRST_CALL_N, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    target = torch.rand((1, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    with torch.no_grad():
        ref = pipe.encode(x)
    factor = pipe.pool_factor
    eps = 8 / 255 * 2

    def drift(adv, ref_codes):  # the runner's pgd / fgsm objective
        return ((pipe.encoder(avg_pool(adv, factor)).float() - ref_codes.float()) ** 2).mean()

    def seeded():
        return torch.Generator(device="cuda").manual_seed(22)

    def drift_case(alpha):
        def of(n):
            cfg = PGDConfig(eps=eps, alpha=alpha, steps=n, random_start=True)
            return (lambda: make_pgd(drift, cfg, fixed=(pipe,)), lambda a: a(x, seeded(), ref),
                    lambda: pgd_eager(drift, cfg, x, pgd_random_start(x, seeded(), cfg), ref))
        return of

    def fusion_case(n):
        cfg = FusionAttackConfig(pgd=PGDConfig(eps=eps, alpha=0.01 * 2, steps=n))
        pc = PGDConfig(eps=eps, alpha=0.01 * 2, steps=n, targeted=True)
        return (lambda: make_fusion_attack(pipe, cfg), lambda a: a(x, target, seeded()),
                lambda: pgd_eager(make_fusion_loss(pipe, cfg), pc, x,
                                  pgd_random_start(x, seeded(), pc), target))

    def whitebox_case(n):
        cfg = WhiteboxConfig(lr=WB_LR, n_iters=n, weights=PRESET_ATTACK_MAIN)
        return (lambda: make_per_image_whitebox(pipe, cfg), lambda a: a(x, target),
                lambda: run_eager(pipe, cfg, x, target, per_image=True))

    cases = {"fgsm": drift_case(eps), "pgd": drift_case(0.01 * 2),
             "fusion_pgd_arith": fusion_case, "white_box_target": whitebox_case}
    out = {}
    for name, steps in FIRST_CALL_STEPS.items():
        of = cases[name]
        make1, call1, _ = of(1)
        call1(make1())  # warm-up: kernels, cuDNN plans at these shapes
        make, call, eager = of(steps)
        attack = make()
        got, first_ms = _wall_ms(torch, lambda: call(attack))
        _, second_ms = _wall_ms(torch, lambda: call(attack))
        want, eager_ms = _wall_ms(torch, eager)
        for t in _leaves((got, want)):
            if not bool(torch.isfinite(_as_tensor(torch, t)).all()):
                fail(f"first call {name}: a non-finite result")
        captured = [p for p in attack.programs if p.graph is not None]
        out[name] = dict(steps=steps, first_ms=first_ms, second_ms=second_ms, eager_ms=eager_ms,
                         capture_ms=sum(p.capture_ms for p in captured), graphs=len(captured))
        attack.programs.release()
        release_cache(torch)
        log(f"  {name}, {steps} steps: a new attack's call {first_ms:.3f} ms, the second call "
            f"{second_ms:.3f} ms (the captures {out[name]['capture_ms']:.3f} ms, "
            f"{len(captured)} graphs), the eager twin {eager_ms:.3f} ms [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 5b: the white-box main path at full width
# ---------------------------------------------------------------------------

WB_N, WB_ITERS, WB_LR = 5, 5, 1e-4  # configs/ffhq_whitebox.json: N=5, lr 1e-4


def run_whitebox_path(torch, card, pipe):
    """``run_whitebox`` on N = 5 1024^2 inputs, all attacked toward one
    target (white_box_target), PRESET_ATTACK_MAIN, lr 1e-4: one warm-up
    iteration, then with the launch counts set to 0 just before and read
    just after: a ``WB_ITERS``-iteration ``run_whitebox``, and the per-image
    attack it calls (``make_per_image_whitebox``) called twice on the same
    inputs (the first call captures its step, the second is timed); then,
    outside the counted run, the timed graph held to its eager twin under
    the same flags and a new graph held bit-equal to it under
    ``deterministic``. Returns what phase 6b profiles: a function that builds and captures a
    white-box attack."""
    from tpufusion_torch import ops
    from tpufusion_torch.attacks.whitebox import (
        PRESET_ATTACK_MAIN, WhiteboxConfig, make_per_image_whitebox, run_eager, run_whitebox)
    from tpufusion_torch.ops.adam_update import B1, B2

    gen = torch.Generator(device="cuda").manual_seed(5)
    inputs = torch.rand((WB_N, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    target = torch.rand((1, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    cfg = WhiteboxConfig(lr=WB_LR, n_iters=WB_ITERS, weights=PRESET_ATTACK_MAIN)
    run_whitebox(pipe, inputs, target, dataclasses.replace(cfg, n_iters=1))  # warm-up
    torch.cuda.synchronize()

    reset_counts()
    adv_entry, _ = run_whitebox(pipe, inputs, target, cfg)
    attack = make_per_image_whitebox(pipe, cfg)
    (adv, trace), g = graphed_timing(
        torch, lambda: attack(inputs, target), attack, WB_ITERS,
        eager=lambda: run_eager(pipe, cfg, inputs, target, per_image=True), what="white-box")
    launches = read_counts()
    step_ms, peak_gib = g["step_ms"], g["peak_gib"]
    per_step = dict(g["per_replay"])

    totals = trace["total"].float().cpu()
    for a in (adv, adv_entry):
        if tuple(a.shape) != tuple(inputs.shape):
            fail(f"white-box adv has shape {tuple(a.shape)}")
    for k, v in trace.items():
        if tuple(v.shape) != (WB_N, WB_ITERS) or not torch.isfinite(v).all():
            fail(f"white-box trace {k}: shape {tuple(v.shape)} or non-finite values")
    moved = (adv - inputs).abs().max().item()
    adam_bound = WB_ITERS * WB_LR * (1 - B1) / math.sqrt(1 - B2)
    if not (torch.isfinite(adv).all() and 0 < moved <= adam_bound + 1e-6):
        fail(f"white-box pixels moved {moved}, expected in (0, {adam_bound}]")
    per_fwd, n_up = family_expectations(pipe.generator.conv_plan())
    need = {"fused_adam": WB_ITERS, "styled_conv": per_fwd * WB_ITERS,
            "styled_conv_bwd": per_fwd * WB_ITERS, "styled_conv_up_bwd": n_up * WB_ITERS}
    # the backward pairs of every styled and up conv (9 + 8 at 1024^2) a
    # replay, and no recomputed composite
    if (per_step.get("styled_conv_bwd"), per_step.get("styled_conv_up_bwd"),
            per_step.get("styled_conv_bwd_composite")) != (per_fwd, n_up, 0):
        fail(f"a white-box replay launches styled_conv_bwd {per_step.get('styled_conv_bwd')}, "
             f"styled_conv_up_bwd {per_step.get('styled_conv_up_bwd')} and the composite "
             f"{per_step.get('styled_conv_bwd_composite')} times, expected {per_fwd}, {n_up}, 0")
    # measured: one launch a replay, and one a step of run_whitebox and of
    # graphed_timing's calls, exactly
    if per_step.get("fused_adam") != 1:
        fail(f"a white-box replay launches fused_adam {per_step.get('fused_adam')} times")
    if launches["fused_adam"] != WB_ITERS + g["steps"]:
        fail(f"{WB_ITERS + g['steps']} white-box steps launched fused_adam "
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
        f"mean of a {WB_ITERS}-iteration per-image attack, its reference bundle included: "
        f"graph replays, the second call of one attack)")
    log_graph(card, "whitebox", g)
    log(f"  whitebox_peak_memory_gib {peak_gib:.3f} [{card}]")
    log(f"  per-image total trace {totals.tolist()}")
    log(f"  pixels moved at most {moved:.6e} (Adam bound {adam_bound:.6e}); total fell "
        f"for every image: {first.tolist()} -> {last.tolist()}")
    log(f"  launches {launches} (per white-box iteration {per_step})")
    timed_hold = g["hold"]()
    attack.programs.release()
    hold_graphs("white-box", g, timed_hold)
    release_cache(torch)

    def profiled():
        att = make_per_image_whitebox(pipe, dataclasses.replace(cfg, n_iters=2))
        att(inputs, target)
        return att
    return launches, per_step, dict(
        whitebox_step_ms=step_ms, whitebox_peak_memory_gib=peak_gib,
        **graph_numbers("whitebox", g, timed_hold),
        whitebox_total_trace=totals.tolist(), whitebox_moved_max=moved,
        whitebox_adam_bound=adam_bound), profiled


# ---------------------------------------------------------------------------
# phase 5c: the spatial-fusion main path at full width
# ---------------------------------------------------------------------------

SPATIAL_N, SPATIAL_STEPS = 5, 5  # the ffhq roles; BASELINE config 3
FUSION_MODES = ("spatial", "arithmetic")
PARTIAL_TOL = 3e-2  # batch 6 against batch 1 in bf16, of max(1, max|ref|)
# the fewest launches of each kernel in one spatial PGD step: the fused
# synthesis's 9 styled convs, its backward's pairs (9 styled, 8 up), the
# pixel update
SPATIAL_STEP_MIN = {"styled_conv": 9, "styled_conv_bwd": 9, "styled_conv_up_bwd": 8,
                    "pgd_update": 1}


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
    FGSM and a 5-step PGD attack at the default eps and alpha called twice
    (the first call captures its step, the second is timed), then the evaluation
    of the attack: the benign fusions and the partial fusions of both modes
    with their metrics (``partial_eval_ms``: both modes' partial fusions and
    metrics, after one untimed round). The counts are read at the end."""
    from tpufusion_torch import ops
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, fgsm_on_fusion, make_fused_image_fn, make_fusion_attack,
        make_fusion_loss)
    from tpufusion_torch.attacks.pgd import pgd_eager, pgd_random_start
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

    pc = dataclasses.replace(pgd_cfg.pgd, targeted=pgd_cfg.targeted)

    def seeded():
        return torch.Generator(device="cuda").manual_seed(12)

    def eager():
        return pgd_eager(make_fusion_loss(pipe, pgd_cfg), pc, inputs,
                         pgd_random_start(inputs, seeded(), pc), target)

    reset_counts()
    n_fwd = 3
    with torch.no_grad():
        t0 = time.perf_counter()
        for _ in range(n_fwd):
            fused = fused_fn(inputs)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3 / n_fwd
    fwd_launches = read_counts()["styled_conv"]
    adv1, tr1 = fgsm_on_fusion(pipe, mode="spatial", objective="vgg")(inputs, target)
    attack = make_fusion_attack(pipe, pgd_cfg)
    (adv, trace), g = graphed_timing(torch, lambda: attack(inputs, target, seeded()), attack,
                                     SPATIAL_STEPS, eager=eager, what="spatial PGD")
    step_ms, peak_gib, per_step = g["step_ms"], g["peak_gib"], dict(g["per_replay"])

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

        before_eval = read_counts()["styled_conv"]
        evaluate()
        eval_launches = read_counts()["styled_conv"] - before_eval
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluated = evaluate()
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        ref = spatial_fusion(pipe.drawer, adv_latents)[0]
    launches = read_counts()

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
    log_graph(card, "spatial pgd", g)
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
    timed_hold = g["hold"]()
    attack.programs.release()
    hold_graphs("spatial PGD", g, timed_hold)
    release_cache(torch)
    return launches, per_step, dict(
        spatial_fused_forward_ms=fwd_ms, spatial_pgd_step_ms=step_ms,
        **graph_numbers("spatial", g, timed_hold),
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
PATCH_PATH_KERNELS = ("styled_conv", "styled_conv_bwd", "styled_conv_up_bwd", "fused_adam")


def _fuse_ok(torch, fused, n=1, size=1024):
    return tuple(fused.shape) == (n, size, size, 3) and bool(torch.isfinite(fused).all())


def patch_launch_failures(launches):
    """What phase 5d's launch counts fall short of: styled_conv, both
    styled backward pairs and fused_adam launched, the weight grad not
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
    of both modes; (c) ``white_box_patch``: ``run_whitebox``'s per-image
    attack toward the per-image paste targets (the second of two calls
    timed); (d) the baselines, each fused arithmetically;
    (e) the hybrid splice of the blur and dp batches; (f) both legacy
    variants on one image. Returns the launch counts, the launches per patch
    inner step, the numbers and a patch batch for phase 6d."""
    from tpufusion_torch import ops
    from tpufusion_torch.attacks import (
        PRESET_ATTACK_MAIN, LegacyOptimizeConfig, PatchConfig, WhiteboxConfig, apply_patch,
        canonical_canvas, dp_noise, gaussian_blur_noise, init_patch_square,
        make_fused_image_fn, make_legacy_optimize, make_patch_attack_step, out_domain_more,
        out_domain_single, paste_patch, splice_hybrid, train_patch)
    from tpufusion_torch.attacks.whitebox import make_per_image_whitebox
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
    reset_counts()
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
    patch_counts = read_counts()
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
    # run_whitebox's per-image attack on every row, called twice: the first
    # call captures its step, the second is timed (its fused_adam launches
    # measured: one a replay)
    wbp = make_per_image_whitebox(pipe, wcfg)
    (adv, trace), g = graphed_timing(torch, lambda: wbp(inputs, targets), wbp, WBP_ITERS)
    wbp.programs.release()
    out["whitebox_patch_step_ms"], out["whitebox_patch_peak_memory_gib"] = (g["step_ms"],
                                                                            g["peak_gib"])
    adam_launches = g["counts"]["fused_adam"]
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

    launches = read_counts()
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
    from tpufusion_torch.attacks.cw import CWConfig, cw_eager, make_cw
    from tpufusion_torch.attacks.pgd import PGDConfig, make_pgd, pgd_eager, pgd_random_start
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
    def seeded():
        return torch.Generator(device="cuda").manual_seed(13)

    torch.cuda.synchronize()
    reset_counts()
    t_phase = time.perf_counter()
    out = {}

    def hold_now(name, attack, g):
        # the timed graphs against their eager twin: a comparison, not counted
        with uncounted():
            hold = g["hold"]()
        out.update(graph_numbers(name, g, hold))
        attack.programs.release()
        hold_graphs(name, g, hold)

    # (1) classifier PGD
    pgd1(x, gen, resnet, labels)  # warm-up (cuDNN plans)
    (adv, trace), g = graphed_timing(
        torch, lambda: pgd(x, seeded(), resnet, labels), pgd, CLF_STEPS,
        eager=lambda: pgd_eager(ce_of(fn), cfg, x, pgd_random_start(x, seeded(), cfg), resnet,
                                labels), what="classifier PGD", atol=GRAPH_ATOL["classifier"])
    ms, peak, pgd_counts = g["step_ms"] * CLF_STEPS, g["peak_gib"], g["counts"]
    log_graph(card, "classifier pgd", g)
    hold_now("classifier_pgd", pgd, g)
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
    cw = cw_of(CWConfig(steps=CW_STEPS))
    (best_adv, best_l2), g = graphed_timing(
        torch, lambda: cw(x, labels, resnet), cw, CW_STEPS,
        eager=lambda: cw_eager(lambda im, net: fn(net, im), CWConfig(steps=CW_STEPS), x, labels,
                               resnet), what="CW", atol=GRAPH_ATOL["classifier"])
    ms, peak, cw_counts = g["step_ms"] * CW_STEPS, g["peak_gib"], g["counts"]
    log_graph(card, "cw", g)
    hold_now("cw", cw, g)
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
    (vadv, vtrace), g = graphed_timing(torch, lambda: vit_pgd(xv, seeded(), vit, vit_labels),
                                       vit_pgd, VIT_STEPS)
    ms, peak, vit_counts = g["step_ms"] * VIT_STEPS, g["peak_gib"], g["counts"]
    log_graph(card, "vit pgd", g)
    out.update(graph_numbers("vit_pgd", g))
    vit_pgd.programs.release()
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
    before = read_counts()
    with torch.no_grad():
        clean = pipe.get_latents(x[:TRANSFER_N])
        attacked = pipe.get_latents(adv[:TRANSFER_N])
        fused, metrics = {}, {}
        for m in FUSION_MODES:
            benign = benign_fusion(pipe.drawer, clean, m)[0]
            part = partial_adv_fusion(pipe.drawer, clean, attacked, m)
            fused[m] = (benign, part)
            metrics[m] = [v.tolist() for v in fused_image_metrics(pipe, benign, part)]
    transfer_counts = _diff(read_counts(), before)
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

    launches = read_counts()
    out["classifier_phase_s"] = time.perf_counter() - t_phase
    short = classifier_launch_failures(pgd_counts, cw_counts, vit_counts, transfer_counts)
    if short:
        fail("; ".join(short))
    per_step = {k: v / CLF_STEPS for k, v in pgd_counts.items()}
    per_step["fused_adam"] = cw_counts["fused_adam"] / CW_STEPS
    log(f"  launches {launches} (resnet PGD {pgd_counts}; CW {cw_counts}; ViT PGD "
        f"{vit_counts}; transfer fusions {transfer_counts}); phase 5e "
        f"{out['classifier_phase_s']:.1f} s [{card}]")

    release_cache(torch)

    # phase 6e's steps: one replay each of 2-step attacks (the first step
    # of a program is eager, the second its first replay)
    pgd2 = make_pgd(ce_of(fn), dataclasses.replace(cfg, steps=2))
    cw2 = cw_of(CWConfig(steps=2))
    vit2 = make_pgd(ce_of(vit_fn), dataclasses.replace(cfg, steps=2))
    pgd2(x, gen, resnet, labels)
    cw2(x, labels, resnet)
    vit2(xv, gen, vit, vit_labels)
    steps = {}
    for metric, attack in (("classifier_pgd_step_ms", pgd2), ("cw_step_ms", cw2),
                           ("vit_pgd_step_ms", vit2)):
        steps[metric] = replay_step(list(attack.programs)[0])
        steps[metric].release = attack.programs.release
    steps["realism_ms"] = lambda: realism_scores(disc, batch)
    return launches, per_step, out, steps


# ---------------------------------------------------------------------------
# phase 5f: the attack_run CLI at full width, images on disk, --align
# ---------------------------------------------------------------------------

CLI_N = 5  # the ffhq fusion roles
CLI_FACE_SEED = 5
CLI_ATTACKS = ("fusion_pgd_arith", "white_box_target", "blur")
CLI_STEPS = 2  # --pgd_steps and --n_iters
# AttackRunConfig's pgd_eps (8/255) doubled for the [-1, 1] range, as the
# runner does
CLI_EPS = 8.0 / 255.0 * 2.0
CLI_PGD_ATTACKS = ("fusion_pgd_arith",)
# the kernels the CLI's attacks must launch: the fusion PGD's synthesis,
# its backward's pairs and pixel update; the white-box Adam
CLI_KERNELS = ("styled_conv", "styled_conv_bwd", "styled_conv_up_bwd", "pgd_update", "fused_adam")
# the landmark net on the card against the CPU, in pixels of a 1024^2 image,
# landmarks and the alignment quad's corners
LANDMARK_TOL_PX = 1.0


def cli_launch_failures(launches):
    """What phase 5f's launch counts fall short of: each kernel of
    ``CLI_KERNELS`` launched at least once by the CLI's run."""
    return [f"phase 5f launched {k} no time" for k in CLI_KERNELS if launches.get(k, 0) <= 0]


def landmark_failures(card_pts, cpu_pts, tol=LANDMARK_TOL_PX):
    """The largest landmark and quad-corner distance (pixels) between the
    card's and the CPU's landmarks of each image, and what exceeds ``tol``."""
    from tpufusion_torch.data.alignment import alignment_quad

    lm = max(float(abs(a - b).max()) for a, b in zip(card_pts, cpu_pts))
    quad = max(float(abs(alignment_quad(a)[0] - alignment_quad(b)[0]).max())
               for a, b in zip(card_pts, cpu_pts))
    out = [f"landmarks on the card differ from the CPU's by {v:.4f} px > {tol} ({what})"
           for what, v in (("landmarks", lm), ("quad corners", quad)) if not v <= tol]
    return lm, quad, out


def _finite_numbers(obj):
    if isinstance(obj, (list, tuple)):
        return all(_finite_numbers(v) for v in obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return math.isfinite(obj)
    return True


def cli_run_failures(root, attacks, n, size, eps=CLI_EPS, pgd_attacks=CLI_PGD_ATTACKS,
                     dataset="ffhq"):
    """What the CLI's run folders under ``root`` (its ``save_dir/<dataset>``)
    fall short of: one ``<k>_<dataset>_<attack>...`` folder per attack, holding
    ``parameters.txt``, a ``results.jsonl`` of finite numbers with N and N+1
    entries, a readable ``new_mask.xlsx`` of N + 6 (N+1) columns, and
    ``adversarial/all_inputs.npz`` and ``all_adv_inputs.npz`` with N finite
    images of ``size``^2; a PGD attack's images lie within ``eps`` of the
    inputs and inside [-1, 1]."""
    import numpy as np

    from tpufusion_torch.io.xlsx import read_xlsx

    out = []
    names = sorted(os.listdir(root)) if os.path.isdir(root) else []
    for attack in attacks:
        dirs = [d for d in names if re.fullmatch(rf"\d+_{dataset}_{attack}(_.*)?", d)]
        if len(dirs) != 1:
            out.append(f"{attack}: {len(dirs)} run folders under {root}, expected 1")
            continue
        run = os.path.join(root, dirs[0])
        if not os.path.isfile(os.path.join(run, "parameters.txt")):
            out.append(f"{attack}: no parameters.txt")
        try:
            with open(os.path.join(run, "results.jsonl")) as f:
                rows = [json.loads(line) for line in f if line.strip()]
        except (OSError, ValueError) as e:
            out.append(f"{attack}: results.jsonl unreadable ({e})")
            rows = []
        if not rows:
            out.append(f"{attack}: results.jsonl holds no row")
        for r in rows:
            if not _finite_numbers(list(r.values())):
                out.append(f"{attack}: results.jsonl holds a non-finite value: {r}")
            if any(len(r.get(k, ())) != n + 1 for k in (
                    "cri_spatial", "cri_arith", "vg_spatial", "vg_arith",
                    "ssim_spatial", "ssim_arith")):
                out.append(f"{attack}: a results.jsonl row lacks N+1 = {n + 1} entries")
        try:
            cols, table = read_xlsx(os.path.join(run, "new_mask.xlsx"))
            if len(cols) != n + 6 * (n + 1) or len(table) != len(rows):
                out.append(f"{attack}: new_mask.xlsx has {len(cols)} columns and "
                           f"{len(table)} rows")
        except Exception as e:  # any reader error is a finding of the run
            out.append(f"{attack}: new_mask.xlsx unreadable ({e})")
        arrays = {}
        for name in ("all_inputs", "all_adv_inputs"):
            try:
                with np.load(os.path.join(run, "adversarial", f"{name}.npz")) as f:
                    arrays[name] = f["data"]
            except (OSError, KeyError, ValueError) as e:
                out.append(f"{attack}: adversarial/{name}.npz unreadable ({e})")
        if len(arrays) < 2:
            continue
        x, adv = arrays["all_inputs"], arrays["all_adv_inputs"]
        for name, a in arrays.items():
            if a.shape != (n, size, size, 3) or not np.isfinite(a).all():
                out.append(f"{attack}: {name} has shape {a.shape} or non-finite values, "
                           f"expected ({n}, {size}, {size}, 3)")
        if attack in pgd_attacks and adv.shape == x.shape:
            dev = float(np.abs(adv - x).max())
            if not dev <= eps + 1e-6:
                out.append(f"{attack}: adv leaves the eps-ball ({dev} > {eps})")
            if not (adv.min() >= -1.0 and adv.max() <= 1.0):
                out.append(f"{attack}: adv leaves [-1, 1]")
    return out


def _write_faces(directory, n, size, seed=CLI_FACE_SEED):
    """``n`` synthetic faces of ``size``^2 (the port's ``synth_face_batch``,
    photometric augmentation on) as PNGs under ``directory``."""
    import numpy as np
    from PIL import Image

    from tpufusion_torch.core.imaging import to_uint8
    from tpufusion_torch.models.landmarks import synth_face_batch

    os.makedirs(directory, exist_ok=True)
    imgs, _ = synth_face_batch(np.random.RandomState(seed), n, size, augment=True)
    paths = []
    for i, img in enumerate(imgs):
        paths.append(os.path.join(directory, f"face_{i}.png"))
        Image.fromarray(to_uint8(img)).save(paths[-1])
    return paths


def run_cli_path(torch, card):
    """Phase 5f: 5 synthetic 1024^2 faces written as PNGs; the packaged
    landmark net on the card held to the CPU (landmarks and quad corners,
    1 px), the bf16 variant's distance printed beside it; then
    ``tpufusion_torch.cli.attack_run.main`` in this process with ``--align``
    and three attacks, building its own full-width pipeline, with the launch
    counts set to 0 just before and read just after, each attack's time, the
    run folders checked; then ``invert`` and ``fuse`` at ``--tiny`` on the
    card. Returns the launch counts and the numbers."""
    import shutil

    from tpufusion_torch import ops, runner
    from tpufusion_torch.cli import attack_run, fuse, invert
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.data.alignment import align_face
    from tpufusion_torch.models.landmarks import (
        load_packaged_landmark_net, make_landmark_provider)

    work = os.path.join(HERE, "runs", "chip_smoke", "cli")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    faces = _write_faces(os.path.join(work, "faces"), CLI_N, 1024)
    log(f"  wrote {CLI_N} synthetic 1024^2 faces in {time.perf_counter() - t0:.2f} s")

    # the landmark net: card against CPU, and the card's alignment timed
    net, size = load_packaged_landmark_net(device="cuda")
    cpu_net, _ = load_packaged_landmark_net(device="cpu")
    on_card = make_landmark_provider(net, net_input_size=size)
    cpu_pts = [make_landmark_provider(cpu_net, net_input_size=size)(p) for p in faces]
    on_card(faces[0])  # warm-up: cuDNN plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_pts = []
    for p in faces:
        card_pts.append(on_card(p))
        align_face(p, card_pts[-1])
    align_s = time.perf_counter() - t0
    lm_px, quad_px, bad = landmark_failures(card_pts, cpu_pts)
    if bad:
        fail("; ".join(bad))
    bf16 = load_packaged_landmark_net(device="cuda", policy=Policy(torch.bfloat16))[0]
    bf16_pts = [make_landmark_provider(bf16, net_input_size=size)(p) for p in faces]
    lm_bf16, quad_bf16, _ = landmark_failures(bf16_pts, cpu_pts)
    log(f"  landmark net (float32) on the card vs the CPU: landmarks {lm_px:.6f} px, quad "
        f"corners {quad_px:.6f} px (limit {LANDMARK_TOL_PX}); a bf16 net would give "
        f"{lm_bf16:.6f} / {quad_bf16:.6f} px [{card}]")
    log(f"  align_s {align_s:.3f} ({CLI_N} faces: landmarks + align_face, card) [{card}]")

    # the CLI, with each attack's dispatch timed
    attack_ms = {}
    dispatch = runner.dispatch_attack

    def timed_dispatch(pipeline, attack, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = dispatch(pipeline, attack, *a, **k)
        torch.cuda.synchronize()
        attack_ms[attack] = (time.perf_counter() - t) * 1e3
        return out

    save = os.path.join(work, "runs")
    argv = ["--dataset", "ffhq", "--images_dir", os.path.dirname(faces[0]), "--align",
            "--attacks", *CLI_ATTACKS, "--pgd_steps", str(CLI_STEPS), "--n_iters",
            str(CLI_STEPS), "--max_num_fusion", "1", "--save_dir", save]
    log(f"  python -m tpufusion_torch.cli.attack_run {' '.join(argv)}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runner.dispatch_attack = timed_dispatch
    reset_counts()
    audit_s = AUDIT.seconds if AUDIT is not None else 0.0
    t0 = time.perf_counter()
    try:
        rc = attack_run.main(argv)
        torch.cuda.synchronize()
    finally:
        runner.dispatch_attack = dispatch
    cli_run_s = time.perf_counter() - t0
    audit_s = (AUDIT.seconds if AUDIT is not None else 0.0) - audit_s
    launches = read_counts()
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if rc != 0:
        fail(f"attack_run returned {rc}")
    bad = cli_run_failures(os.path.join(save, "ffhq"), CLI_ATTACKS, CLI_N, 1024)
    bad += cli_launch_failures(launches)
    if bad:
        fail("; ".join(bad))
    log(f"  cli_run_s {cli_run_s:.3f} (pipeline build, load + align, 3 attacks with their "
        f"evaluations and artifacts; of it {audit_s:.3f} s the launch audit's profiled first "
        f"replays) [{card}]")
    for attack in CLI_ATTACKS:
        steps = "" if attack == "blur" else f", {CLI_STEPS} steps"
        log(f"  {attack}_ms {attack_ms[attack]:.3f} (dispatch{steps}) [{card}]")
    log(f"  cli_peak_memory_gib {peak_gib:.3f} (above the {base / 2 ** 30:.3f} GiB held "
        f"before it) [{card}]")
    log(f"  launches {launches}")

    # invert and fuse at --tiny on the card
    inv = os.path.join(work, "invert")
    if invert.main(["--images_dir", os.path.dirname(faces[0]), "--dataset", "ffhq", "--tiny",
                    "--size", "32", "--batch", str(CLI_N), "--save_dir", inv]) != 0:
        fail("invert returned non-zero")
    import numpy as np

    with np.load(os.path.join(inv, "latents.npz")) as f:
        lat = f["latents"]
    inversions = sorted(os.listdir(os.path.join(inv, "inversions")))
    if lat.shape[0] != CLI_N or not np.isfinite(lat).all() or len(inversions) != CLI_N:
        fail(f"invert wrote latents {lat.shape} and {len(inversions)} inversions")
    demo = os.path.join(work, "fused_demo.jpg")
    if fuse.main(["--dataset", "ffhq", "--tiny", "--size", "32", "--out", demo]) != 0 \
            or not os.path.isfile(demo):
        fail("fuse wrote no montage")
    log(f"  invert: latents {lat.shape}, {len(inversions)} inversions; fuse: {demo}")
    shutil.rmtree(work, ignore_errors=True)
    return launches, dict(cli_run_s=cli_run_s, cli_audit_s=audit_s, align_s=align_s,
                          cli_peak_memory_gib=peak_gib,
                          landmark_px=lm_px, quad_px=quad_px, landmark_bf16_px=lm_bf16,
                          quad_bf16_px=quad_bf16,
                          **{f"cli_{a}_ms": v for a, v in attack_ms.items()})


# ---------------------------------------------------------------------------
# phase 5g: the scale-out routes on a one-rank NCCL mesh, the DCP resume and
# the exported serving programs, at full width
# ---------------------------------------------------------------------------

SH_N, SH_ITERS, SH_LR = 5, 2, 1e-4  # white-box: configs/ffhq_whitebox.json's N and lr
SH_PGD_STEPS = 2  # the runner's PGD (encoder drift) and the group fusion PGD
SH_CW_N, SH_CW_STEPS, SH_CW_LR = 8, 5, 0.01  # resnet18 CW, the runner's lr
SH_GROUPS = 2  # fusion groups of N = 5
SH_PATCH_IMAGES, SH_PATCH_COUNT = 2, 2  # 1 epoch, max_count 2
# the kernels each counted run of phase 5g must launch: the sharded routes,
# the attacks' kernels; the DCP resume's two white-box
# iterations, the synthesis, its backward and Adam; the exported programs'
# forwards, the synthesis
PHASE_5G_KERNELS = {
    "sharded": ("styled_conv", "styled_conv_bwd", "styled_conv_up_bwd", "pgd_update",
                "fused_adam"),
    "resume": ("styled_conv", "styled_conv_bwd", "styled_conv_up_bwd", "fused_adam"),
    "export": ("styled_conv",),
}
# With deterministic algorithms required, the one-rank routes run the
# single-device routes' ops on the same rows and are held bit-equal to
# them, but for two. The patch route is held to the step written out on one
# device (``_patch_reference``): the all-reduced weighted sum and the mean
# over images round apart, by about 2e-7 on an H100. CW: its pixels
# within a few float32 ulps of 1, its best L2 within 1e-5 of itself (set
# while PyTorch's resize backward, with atomics, ran under it).
SH_PATCH_ATOL, SH_PATCH_RTOL = 1e-5, 1e-4
SH_CW_ATOL, SH_CW_L2_RTOL = 1e-6, 1e-5
DISPATCH_CALLS = 200


def sharded_launch_failures(counts):
    """What phase 5g's launch counts fall short of: ``counts`` maps each run
    of ``PHASE_5G_KERNELS`` to its launch counts, and each kernel that run
    must launch is launched at least once in it."""
    return [f"phase 5g's {run} run launched {k} no time"
            for run, keys in PHASE_5G_KERNELS.items() for k in keys
            if counts.get(run, {}).get(k, 0) <= 0]


def held_failures(torch, what, got, want, *, atol=0.0, rtol=0.0):
    """``(max |got - want|, failures)``: the shapes agree, ``got`` is finite
    where ``want`` is (and equal where it is not, as CW's inf for no
    success), and within ``atol + rtol * max(1, max|want|)`` of ``want``."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf, [f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}"]
    got, want = got.float(), want.float()
    ok = torch.isfinite(want)
    if bool((torch.isfinite(got) != ok).any()) or not bool((got[~ok] == want[~ok]).all()):
        return math.inf, [f"{what}: finite where the single-device route is not, or back"]
    if not bool(ok.any()):
        return 0.0, []
    err = (got[ok] - want[ok]).abs().max().item()
    lim = atol + rtol * max(1.0, want[ok].abs().max().item())
    return err, ([] if err <= lim else [f"{what}: {err:.3e} > {lim:.3e} from the "
                                        f"single-device route"])


def _patch_reference(torch, pipe, imgs, patch, draws, cfg):
    """The batch-synchronous patch step on one device, written out: every
    image's placement fixed, the mean over images of the encoder drift,
    ``patch -= step_size * grad`` clamped to the batch's range, ``max_count``
    times. Returns the patch and its loss trace."""
    from tpufusion_torch.attacks.patch import square_transform
    from tpufusion_torch.core.imaging import avg_pool

    f, size = pipe.pool_factor, pipe.image_size
    with torch.no_grad():
        latent = pipe.encoder(avg_pool(imgs, f))
        masks = torch.stack([square_transform(patch, size, draw=d)[1] for d in draws])
    lo, hi = imgs.min(), imgs.max()
    trace = []
    for _ in range(cfg.max_count):
        p = patch.detach().requires_grad_(True)
        canvases = torch.stack([square_transform(p, size, draw=d)[0] for d in draws])
        adv = (1.0 - masks) * imgs + masks * canvases
        d = latent.float() - pipe.encoder(avg_pool(adv, f)).float()
        loss = cfg.w_latent_org * (d * d).flatten(1).mean(dim=1).mean()
        (g,) = torch.autograd.grad(loss, p)
        with torch.no_grad():
            patch = torch.minimum(torch.maximum(patch - cfg.step_size * g, lo), hi)
        trace.append(loss.detach())
    return patch, torch.stack(trace)


def _dispatch_us(torch):
    """Host µs per call of ``tpufusion::styled_conv`` and of the kernel's
    launch without the operator, at the 4^2 x 512 shape of the synthesis's
    first conv (batch 1, bf16), over ``DISPATCH_CALLS`` calls each."""
    from tpufusion_torch.ops import styled_conv as sc

    g = torch.Generator(device="cuda").manual_seed(12)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    args = (rn(1, 4, 4, 512).bfloat16(), rn(3, 3, 512, 512), rn(1, 512) * 0.5 + 1,
            rn(1, 4, 4, 1), torch.tensor(0.2, device="cuda"), rn(512) * 0.1)
    out = {}
    for name, fn in (("op", sc.styled_conv_op), ("kernel", sc.styled_conv_kernel)):
        for _ in range(10):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn(*args)
        out[name] = (time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS
        torch.cuda.synchronize()
    return out


def run_sharded_path(torch, card, pipe):
    """Phase 5g on the pipeline of phase 5 (FFHQ 1024^2, published widths):
    a one-rank NCCL ``('data', 'model')`` mesh (``parallel.create_mesh``),
    cudnn.deterministic on and deterministic algorithms required. The
    single-device routes run first; then three counted runs: the sharded
    routes (white-box N = 5, 2 iterations; the runner's PGD, N = 5, 2 steps
    from one explicit start; resnet18 CW, 8 x 1024^2, 5 steps; the patch, 1
    epoch of 2 images, max_count 2; the group fusion attack, G = 2 groups of
    N = 5 in both modes, 2 steps, and the group evaluation), each held to
    its single-device route; a DCP checkpoint of the white-box state written
    and restored, and the white-box run interrupted after one iteration and
    resumed from it, equal to the whole run; ``export_decode`` and
    ``export_spatial_fusion`` at 1024^2, saved, loaded and run against the
    eager forwards. Returns the launch counts of each run ("sharded",
    "resume", "export") and the numbers."""
    import shutil

    import torch.distributed as dist

    from tpufusion_torch import ops
    from tpufusion_torch import parallel as P
    from tpufusion_torch.attacks.cw import CWConfig, make_cw
    from tpufusion_torch.attacks.fusion_attack import FusionAttackConfig, make_fusion_attack
    from tpufusion_torch.attacks.patch import (
        PatchConfig, canonical_canvas, draw_placement, init_patch_square)
    from tpufusion_torch.attacks.pgd import PGDConfig, make_pgd, pgd_random_start
    from tpufusion_torch.attacks.whitebox import WhiteboxConfig, run_whitebox
    from tpufusion_torch.core.imaging import avg_pool
    from tpufusion_torch.core.prng import split_generator
    from tpufusion_torch.eval import benign_fusion, fused_image_metrics, partial_adv_fusion
    from tpufusion_torch.eval.metrics import mse_per_image
    from tpufusion_torch.fusion.spatial import ROLE_MAPS, spatial_fused
    from tpufusion_torch.io import dcp_io
    from tpufusion_torch.io.attack_state import run_whitebox_sharded_resumable
    from tpufusion_torch.io.export import (
        export_decode, export_spatial_fusion, load_program, module_params, spatial_roles)
    from tpufusion_torch.models.classifiers import load_gender_classifier
    from tpufusion_torch.parallel.sharding import (
        GROUP_EVAL_KEYS, as_dtensors, make_sharded_whitebox_step, prepare_whitebox_batch,
        to_local)

    failures = []
    nums = {}
    dispatch = _dispatch_us(torch)
    nums.update(dispatch_op_us=dispatch["op"], dispatch_kernel_us=dispatch["kernel"])
    log(f"  tpufusion::styled_conv host time per call {dispatch['op']:.1f} us, the launch "
        f"alone {dispatch['kernel']:.1f} us: the operator adds "
        f"{dispatch['op'] - dispatch['kernel']:.1f} us a call [{card}]")

    # deterministic algorithms required (cuBLAS needs its workspace fixed
    # for that); an op that has none warns on stderr, and the equality
    # gates below decide whether its result still matched
    determinism = contextlib.ExitStack()
    determinism.enter_context(deterministic(torch))
    mesh = P.create_mesh(data=1)
    if tuple(mesh.shape) != (1, 1) or dist.get_backend() != "nccl":
        fail(f"phase 5g mesh {tuple(mesh.shape)} on {dist.get_backend()}, expected (1, 1) nccl")
    work = os.path.join(HERE, "runs", "chip_smoke", "sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    gen = torch.Generator(device="cuda").manual_seed(11)
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda") * 2 - 1  # noqa: E731
    x, target = rand(SH_N, 1024, 1024, 3), rand(1, 1024, 1024, 3)
    wide = target.expand_as(x).contiguous()
    wcfg = WhiteboxConfig(lr=SH_LR, n_iters=SH_ITERS)
    with torch.no_grad():
        ref = pipe.encode(x)
    factor = pipe.pool_factor

    def drift(adv, ref_codes):  # the runner's PGD objective
        return ((pipe.encoder(avg_pool(adv, factor)).float() - ref_codes.float()) ** 2).mean()

    eps = 8 / 255 * 2
    pcfg = PGDConfig(eps=eps, alpha=0.01 * 2, steps=SH_PGD_STEPS, random_start=True)
    start = pgd_random_start(x, gen, pcfg)
    xc = rand(SH_CW_N, 1024, 1024, 3)
    clf_fn, resnet = load_gender_classifier(None, device="cuda", seed=7)
    with torch.no_grad():
        labels = clf_fn(resnet, xc).argmax(-1)
    ccfg = CWConfig(steps=SH_CW_STEPS, lr=SH_CW_LR)
    cw_logits = lambda im, m: clf_fn(m, im)  # noqa: E731
    patch_cfg = PatchConfig(max_count=SH_PATCH_COUNT)
    patch0 = init_patch_square(1024, patch_cfg.patch_frac, gen)
    draws = [draw_placement("square", gen, 1024, patch0.shape[0])
             for _ in range(SH_PATCH_IMAGES)]
    groups = rand(SH_GROUPS, 5, 1024, 1024, 3)
    gcfgs = {mode: FusionAttackConfig(mode=mode, objective="pixel", targeted=True,
                                      pgd=PGDConfig(eps=eps, alpha=0.01 * 2,
                                                    steps=SH_PGD_STEPS))
             for mode in ("arithmetic", "spatial")}
    codes = torch.randn((1, pipe.generator.n_latent, 512), generator=gen, device="cuda")
    lat5 = torch.randn((1, 5, pipe.generator.n_latent, 512), generator=gen, device="cuda")

    def group_single(mode):
        root = torch.Generator(device="cuda").manual_seed(13)
        gens = [split_generator(root) for _ in range(SH_GROUPS)]
        attack = make_fusion_attack(pipe, gcfgs[mode])
        runs = [attack(groups[g], target, gens[g]) for g in range(SH_GROUPS)]
        return torch.stack([a for a, _ in runs]), torch.stack([t for _, t in runs])

    def serial_eval(advs):
        out = []
        with torch.no_grad():
            for g in range(SH_GROUPS):
                cb, ca = pipe.get_latents(groups[g]), pipe.get_latents(advs[g])
                e = dict(noise=mse_per_image(groups[g], advs[g]))
                for short, mode in (("sp", "spatial"), ("ar", "arithmetic")):
                    b, _, _ = benign_fusion(pipe.drawer, cb, mode)
                    part = partial_adv_fusion(pipe.drawer, cb, ca, mode)
                    e[f"b_{short}"], e[f"part_{short}"] = b, part
                    e[f"cri_{short}"], e[f"vg_{short}"], e[f"ss_{short}"] = \
                        fused_image_metrics(pipe, b, part)
                out.append(e)
        return {k: torch.stack([e[k].float() for e in out]) for k in GROUP_EVAL_KEYS}

    def whitebox_single():
        adv, trace = run_whitebox(pipe, x, wide, wcfg)
        return adv, trace["total"]

    def group_sharded(mode):
        attack = P.make_sharded_group_fusion_attack(pipe, gcfgs[mode], mesh)
        return attack(groups, target[None], torch.Generator(device="cuda").manual_seed(13))

    routes = {  # name: (single-device route, sharded route, what the time is per, count)
        "whitebox": (whitebox_single, lambda: P.run_whitebox_sharded(
            pipe, x, target, wcfg, None, mesh), "iteration", SH_ITERS),
        "pgd": (lambda: make_pgd(drift, pcfg, external_start=True)(x, start, ref),
                lambda: P.run_pgd_sharded(drift, pcfg, x, None, (ref,), ("batch",), mesh,
                                          start=start), "step", SH_PGD_STEPS),
        "cw": (lambda: make_cw(cw_logits, ccfg)(xc, labels, resnet),
               lambda: P.run_cw_sharded(cw_logits, ccfg, xc, labels, (resnet,), ("rep",), mesh),
               "step", SH_CW_STEPS),
        "patch": (lambda: canonical_canvas(_patch_reference(
            torch, pipe, x[:SH_PATCH_IMAGES], patch0, draws, patch_cfg)[0], 1024, "square")[0],
            lambda: P.train_patch_sharded(
                pipe, [x[i : i + 1] for i in range(SH_PATCH_IMAGES)], None, patch_cfg, mesh,
                init_patch=patch0, draws=[draws])[0], "inner step", SH_PATCH_COUNT),
        "group_arithmetic": (lambda: group_single("arithmetic"),
                             lambda: group_sharded("arithmetic"), "group step",
                             SH_GROUPS * SH_PGD_STEPS),
        "group_spatial": (lambda: group_single("spatial"), lambda: group_sharded("spatial"),
                          "group step", SH_GROUPS * SH_PGD_STEPS),
        "group_eval": (lambda: serial_eval(single["group_arithmetic"][0]),
                       lambda: P.make_sharded_group_eval(pipe, mesh)(
                           groups, single["group_arithmetic"][0]), "group", SH_GROUPS),
    }
    ms = {}

    def run(name, sharded, timed=True):
        single_fn, sharded_fn, _, per = routes[name]
        if not timed:  # the counted run: its programs' first replays are profiled
            return (sharded_fn if sharded else single_fn)()
        with audit_paused(track=False):
            out, t, _ = _timed(torch, sharded_fn if sharded else single_fn)
        ms[(name, sharded)] = t / per
        return out

    # the single-device routes first, outside the counted runs; their times
    # are taken again after the sharded routes, so that both are timed on
    # shapes the card has run in this mode
    single = {}
    for name in routes:  # in order: the evaluation takes the group attack's output
        single[name] = run(name, False)
    with torch.no_grad():
        eager_decode = pipe.decode(codes)
        eager_fused, _ = spatial_fused(pipe.drawer, lat5)

    # three counted runs, each with the counts set to 0 just before it and
    # read just after: the sharded routes, the DCP resume, the exported
    # programs; the sharded and single-device routes are timed in turns
    # after the first
    counts = {}
    torch.cuda.synchronize()
    reset_counts()
    got = {name: run(name, True, timed=False) for name in routes}
    torch.cuda.synchronize()
    counts["sharded"] = read_counts()
    for name in routes:
        run(name, True)
    for name in routes:
        run(name, False)

    # DCP: the white-box state written and restored, then a resumed run
    reset_counts()
    _, init, place = make_sharded_whitebox_step(pipe, wcfg, mesh)
    _, sub_p, targets_p, _ = prepare_whitebox_batch(x, target, None, mesh)
    state = init(*place(sub_p, targets_p))
    ck = os.path.join(work, "state")
    t0 = time.perf_counter()
    dcp_io.save_checkpoint(ck, as_dtensors(mesh, state))
    nums["dcp_save_s"] = time.perf_counter() - t0
    nums["dcp_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                            for d, _, fs in os.walk(ck) for f in fs)
    template = init(*place(sub_p, targets_p))
    template["x"].zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = to_local(dcp_io.restore_checkpoint(ck, as_dtensors(mesh, template)))
    torch.cuda.synchronize()
    nums["dcp_restore_s"] = time.perf_counter() - t0
    if not torch.equal(restored["x"], state["x"]) or not all(
            torch.equal(a, b) for a, b in zip(restored["ref"]["feats_org"],
                                              state["ref"]["feats_org"])):
        failures.append("phase 5g: the DCP-restored white-box state differs from the saved one")
    resume_dir = os.path.join(work, "resume")
    run_whitebox_sharded_resumable(pipe, x, target, dataclasses.replace(wcfg, n_iters=1),
                                   None, mesh, resume_dir, checkpoint_every=1)
    resumed, _, resumed_from = run_whitebox_sharded_resumable(
        pipe, x, target, wcfg, None, mesh, resume_dir, checkpoint_every=1)
    torch.cuda.synchronize()
    counts["resume"] = read_counts()
    if resumed_from != 1:
        failures.append(f"phase 5g: the white-box run resumed from step {resumed_from}, not 1")

    # the serving programs at 1024^2
    reset_counts()
    art = {}
    for name, export, args in (
            ("decode", lambda p: export_decode(pipe, p), (module_params(pipe.generator), codes)),
            ("spatial_fusion", lambda p: export_spatial_fusion(pipe.drawer, p), None)):
        path = os.path.join(work, f"{name}.pt2")
        t0 = time.perf_counter()
        export(path)
        art[f"{name}_export_s"] = time.perf_counter() - t0
        art[f"{name}_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        program = load_program(path)
        art[f"{name}_load_s"] = time.perf_counter() - t0
        if not any("tpufusion.styled_conv" in str(n.target)
                   for n in program.exported.graph.nodes if n.op == "call_function"):
            failures.append(f"phase 5g: the exported {name} holds no tpufusion::styled_conv node")
        if args is None:
            by_role = {r: lat5[:, i] for i, r in enumerate(ROLE_MAPS["ffhq"]["roles"])}
            base, swaps = spatial_roles("ffhq")
            args = (module_params(pipe.generator), module_params(pipe.drawer.blender),
                    pipe.drawer.mean_latent, by_role[base], *[by_role[r] for _, r in swaps])
        out, t, _ = _timed(torch, lambda: program(*args))
        out, t, _ = _timed(torch, lambda: program(*args))  # after a warm-up
        art[f"{name}_forward_ms"] = t
        want = eager_decode if name == "decode" else eager_fused
        art[f"{name}_max_abs_err"], bad = held_failures(torch, f"exported {name}", out, want)
        failures.extend(bad)
    torch.cuda.synchronize()
    counts["export"] = read_counts()

    # each route against its single-device route, bit for bit (the patch
    # to its stated bound); the resumed run against the whole sharded run
    errs = {}
    for k, parts in (("whitebox", ("", " trace")), ("pgd", ("", " trace")),
                     ("group_arithmetic", ("", " trace")), ("group_spatial", ("", " trace")),
                     ("cw", ("", " best L2"))):
        for part, a, b in zip(parts, got[k], single[k]):
            tol = {} if k != "cw" else dict(rtol=SH_CW_L2_RTOL) if part else dict(atol=SH_CW_ATOL)
            err, bad = held_failures(torch, f"sharded {k}{part}", a, b, **tol)
            errs[k] = max(errs.get(k, 0.0), err)
            failures.extend(bad)
    errs["patch"], bad = held_failures(torch, "sharded patch", got["patch"], single["patch"],
                                       atol=SH_PATCH_ATOL, rtol=SH_PATCH_RTOL)
    failures.extend(bad)
    for k in GROUP_EVAL_KEYS:
        err, bad = held_failures(torch, f"sharded group eval {k}", got["group_eval"][k],
                                 single["group_eval"][k])
        errs["group_eval"] = max(errs.get("group_eval", 0.0), err)
        failures.extend(bad)
    errs["resumed"], bad = held_failures(torch, "resumed white-box run", resumed,
                                         got["whitebox"][0])
    failures.extend(bad)
    nums.update({f"sharded_{k}_max_abs_err": v for k, v in errs.items()},
                cw_successes=int(torch.isfinite(got["cw"][1]).sum()))
    failures.extend(sharded_launch_failures(counts))

    determinism.close()
    dist.destroy_process_group()
    shutil.rmtree(work, ignore_errors=True)

    for name, (_, _, per, _) in routes.items():
        s, o = ms[(name, True)], ms[(name, False)]
        nums[f"sharded_{name}_ms"], nums[f"single_{name}_ms"] = s, o
        log(f"  {name}: sharded {s:.3f} ms per {per} against the single-device route's "
            f"{o:.3f} ({(s / o - 1) * 100:+.1f}%; in turns: single, sharded counted, sharded "
            f"timed, single timed) "
            f"[{card}]")
    log("  max |sharded - single-device|: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (the patch within {SH_PATCH_ATOL} + {SH_PATCH_RTOL} of max|single|, CW's pixels "
        f"within {SH_CW_ATOL} and best L2 within {SH_CW_L2_RTOL} of itself, the others "
        "bit-equal)")
    log(f"  CW successes {nums['cw_successes']} of {SH_CW_N} (not gated)")
    log(f"  DCP: white-box state {nums['dcp_bytes']} bytes, saved in {nums['dcp_save_s']:.3f} s, "
        f"restored in {nums['dcp_restore_s']:.3f} s, equal to the saved state; the run resumed "
        f"from step {resumed_from}, max {errs['resumed']:.3e} from the whole run [{card}]")
    for name in ("decode", "spatial_fusion"):
        log(f"  export {name}: {art[f'{name}_export_s']:.2f} s, {art[f'{name}_bytes']} bytes, "
            f"load {art[f'{name}_load_s']:.3f} s, forward {art[f'{name}_forward_ms']:.3f} ms, "
            f"max err {art[f'{name}_max_abs_err']:.3e} against the eager forward [{card}]")
    for run_name, c in counts.items():
        log(f"  launches, {run_name}: {c}")
    if failures:
        fail("; ".join(failures))
    nums.update(art)
    return counts, nums
# ---------------------------------------------------------------------------
# phase 5h: the car (512^2) and church (256^2) families at published widths
# ---------------------------------------------------------------------------

# config-f generator at the family's size, e4e IR-SE-50 at 256^2 (car pools
# by 2, church not at all), VGG16, the fusion nets; seeded random weights
FAMILY_PIPELINE = dict(channel_multiplier=2, encoder_base_channels=64,
                       encoder_units=(3, 4, 14, 3), encoder_input_size=256, seed=0)
FAMILY_FWD = 3  # timed fused forwards
FAMILY_STEPS = 3  # PGD steps after FGSM, spatial PGD steps, white-box iterations, classifier steps
FAMILY_PATCH_COUNT = 2  # one epoch: one image x 2 inner steps
FAMILY_CLI_ATTACKS = ("white_box_target", "fusion_pgd_spatial", "blur")
FAMILY_CLI_PGD = ("fusion_pgd_spatial",)
FAMILY_CLI_STEPS = 2
INVERT_N = 2


def family_expectations(plan):
    """From a generator's ``conv_plan()``: the styled_conv launches of one
    synthesis forward (its non-upsampling 3x3 convs, each one
    ``styled_conv_bwd`` pair in a backward) and its up convs (each one
    ``styled_conv_up_bwd`` pair in a backward)."""
    kinds = [kind for _, _, kind in plan]
    return kinds.count("conv"), kinds.count("up")


def family_launch_failures(fam, plan, runs):
    """What phase 5h's launch counts for family ``fam`` fall short of.
    ``runs`` maps each counted run to its counts: "forwards" (``FAMILY_FWD``
    fused forwards), "pgd_step" and "spatial_step" (per step), "eval" (one
    round of partial fusions, both modes), "whitebox" (``FAMILY_STEPS``
    iterations), "classifier_pgd" and, where it ran, "cw" (``FAMILY_STEPS``
    steps each), "cli" (the attack_run call) and "all" (the whole phase).
    styled_conv exactly ``per_fwd`` a synthesis (``family_expectations``);
    the backward pairs at least ``per_fwd`` and ``n_up`` a step; pgd_update
    once a PGD step; fused_adam once a white-box iteration and a CW step;
    never the recomputed composite, nor conv3x3's kernels (the frozen bf16
    synthesis reaches them only through it), nor the weight grad."""
    per_fwd, n_up = family_expectations(plan)
    out = []

    def need(run, kernel, ok, what):
        got = runs[run][kernel]
        if not ok(got):
            out.append(f"{fam} {run}: {kernel} launched {got} times, expected {what}")

    need("forwards", "styled_conv", lambda v: v == per_fwd * FAMILY_FWD, per_fwd * FAMILY_FWD)
    need("eval", "styled_conv", lambda v: v == 2 * per_fwd, 2 * per_fwd)
    for run in ("pgd_step", "spatial_step"):
        need(run, "styled_conv", lambda v: v >= per_fwd, f">= {per_fwd}")
        need(run, "pgd_update", lambda v: v == 1, 1)
    need("whitebox", "fused_adam", lambda v: v == FAMILY_STEPS, FAMILY_STEPS)
    need("whitebox", "styled_conv", lambda v: v >= per_fwd * FAMILY_STEPS,
         f">= {per_fwd * FAMILY_STEPS}")
    need("classifier_pgd", "pgd_update", lambda v: v == FAMILY_STEPS, FAMILY_STEPS)
    need("classifier_pgd", "fused_adam", lambda v: v == 0, 0)
    if "cw" in runs:
        need("cw", "fused_adam", lambda v: v == FAMILY_STEPS, FAMILY_STEPS)
        need("cw", "pgd_update", lambda v: v == 0, 0)
    for k in ("styled_conv", "pgd_update", "fused_adam"):
        need("cli", k, lambda v: v > 0, "> 0")
    for k, per in (("styled_conv_bwd", per_fwd), ("styled_conv_up_bwd", n_up)):
        for run in ("pgd_step", "spatial_step"):
            need(run, k, lambda v: v >= per, f">= {per}")
        need("whitebox", k, lambda v: v >= per * FAMILY_STEPS, f">= {per * FAMILY_STEPS}")
        need("cli", k, lambda v: v > 0, "> 0")
    for k in ("styled_conv_bwd_composite", "conv3x3_fwd", "conv3x3_dgrad"):
        need("all", k, lambda v: v == 0, 0)
    need("all", "conv3x3_wgrad", lambda v: v == 0, "0 (the weights are frozen)")
    return out


def _montage_size(size, panels=6, pad=2):
    """The (width, height) of ``save_montage``'s strip of ``panels``
    ``size``^2 images (fuse: five parts and the fusion)."""
    return panels * (size + pad) + pad, size + 2 * pad


def run_family_path(torch, card, fam):
    """Phase 5h for one family at its published widths (``FAMILY_STYLED``:
    car 4 x 512^2, church 3 x 256^2), with the launch counts set to 0 just
    before and read just after the whole phase and around each run: (a)
    ``FAMILY_FWD`` timed fused forwards, FGSM, then arithmetic fusion PGD
    (pixel objective) for ``FAMILY_STEPS`` steps; (b) spatial fusion PGD
    ('vgg' objective), ``FAMILY_STEPS`` steps, then the partial-fusion
    evaluation of both modes with its metrics (some iterate of each PGD
    run lies below its start, its pixels in the eps-ball); (c) ``run_whitebox``,
    ``FAMILY_STEPS`` of the preset's iterations, PRESET_ATTACK_MAIN, lr
    1e-4, its reference bundle included; (d) ``train_patch``, one epoch of
    one image x ``FAMILY_PATCH_COUNT`` inner steps at the runner's patch
    size; (e) the family's surrogate from ``runner.classifier_for`` (car:
    ViT-B/16, 196 labels; church: resnet18) under the runner's classifier
    PGD, and for car CW, ``FAMILY_STEPS`` steps each; (f) ``attack_run``
    with ``configs/<family>_whitebox.json`` on N images written at the
    family's size, then for car ``invert`` on 2 images (384 x 512
    inversions), then ``fuse``. Returns the launch counts, the launches per
    arithmetic PGD step and the numbers (keys prefixed with the family)."""
    import shutil

    import numpy as np
    import torch.nn.functional as F
    from PIL import Image

    from tpufusion_torch import ops, runner
    from tpufusion_torch.attacks import (
        CWConfig, PatchConfig, PGDConfig, make_cw, make_pgd, make_patch_attack_step,
        init_patch_square, train_patch)
    from tpufusion_torch.attacks.cw import cw_eager
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, fgsm_on_fusion, make_fused_image_fn, make_fusion_attack,
        make_fusion_loss)
    from tpufusion_torch.attacks.pgd import pgd_eager, pgd_random_start
    from tpufusion_torch.attacks.whitebox import (
        PRESET_ATTACK_MAIN, WhiteboxConfig, make_per_image_whitebox, run_eager, run_whitebox)
    from tpufusion_torch.cli import attack_run, fuse, invert
    from tpufusion_torch.configs import ITER_DICT, AttackRunConfig
    from tpufusion_torch.eval import benign_fusion, fused_image_metrics, partial_adv_fusion
    from tpufusion_torch.ops.adam_update import B1, B2
    from tpufusion_torch.pipeline import FusionPipeline

    n, size = FAMILY_STYLED[fam]
    t0 = time.perf_counter()
    pipe = FusionPipeline.create(fam, device="cuda", size=size, **FAMILY_PIPELINE)
    torch.cuda.synchronize()
    plan = pipe.generator.conv_plan()
    per_fwd, n_up = family_expectations(plan)
    log(f"  {fam} pipeline built in {time.perf_counter() - t0:.2f} s (config-f {size}^2 "
        f"generator, {pipe.generator.n_latent} W+ rows, e4e IR-SE-50 at "
        f"{pipe.encoder_input_size}^2, pool factor {pipe.pool_factor}); per synthesis "
        f"forward {per_fwd} styled convs and {n_up} up convs, a backward pair each")
    gen = torch.Generator(device="cuda").manual_seed(11)
    inputs = torch.rand((n, size, size, 3), generator=gen, device="cuda") * 2 - 1
    target = torch.rand((1, size, size, 3), generator=gen, device="cuda") * 2 - 1
    out, runs, profiles = {}, {}, {}
    tag = f"{fam} {n} x {size}^2"

    def seeded(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def in_ball(name, adv, eps):
        dev = (adv - inputs).abs().max().item()
        if not (torch.isfinite(adv).all() and dev <= eps + 1e-6):
            fail(f"{fam} {name}: adv leaves the eps-ball ({dev} > {eps})")

    def pgd_run(cfg, name):
        """Warm-up step, then FGSM and a ``FAMILY_STEPS``-step PGD attack
        called twice (the second call timed); returns the per-step counts,
        ms, peak, trace and final loss, the adversarial inputs and the
        graph's numbers; the attack's program is profiled
        (``profiles[name]``) and freed."""
        make_fusion_attack(pipe, dataclasses.replace(
            cfg, pgd=dataclasses.replace(cfg.pgd, steps=1)))(inputs, target, gen)
        adv1, tr1 = fgsm_on_fusion(pipe, mode=cfg.mode, objective=cfg.objective)(inputs, target)
        full = dataclasses.replace(cfg, pgd=dataclasses.replace(cfg.pgd, steps=FAMILY_STEPS))
        attack = make_fusion_attack(pipe, full)
        pc = dataclasses.replace(full.pgd, targeted=full.targeted)
        (adv, trace), g = graphed_timing(
            torch, lambda: attack(inputs, target, seeded(16)), attack, FAMILY_STEPS,
            eager=lambda: pgd_eager(make_fusion_loss(pipe, full), pc, inputs,
                                    pgd_random_start(inputs, seeded(16), pc), target),
            what=f"{fam} {name}")
        log_graph(card, f"{fam} {name}", g)
        ms, peak, per_step = g["step_ms"], g["peak_gib"], dict(g["per_replay"])
        log(f"  -- {fam} {name}: one step (a graph replay) under torch.profiler")
        profiles[name] = profile_step(torch, replay_step(list(attack.programs)[0]),
                                      step_ms=ms, what=f"{fam} {name} step ms")
        with uncounted():  # the timed graphs against their eager twin
            hold = g["hold"]()
        g["numbers"] = graph_numbers(name.split()[0], g, hold)
        attack.programs.release()
        hold_graphs(f"{fam} {name}", g, hold)
        with torch.no_grad():
            final = make_fusion_loss(pipe, cfg)(adv, target).item()
        trace = trace.float().cpu().tolist()
        in_ball(f"{name} fgsm", adv1, cfg.pgd.eps)
        in_ball(name, adv, cfg.pgd.eps)
        if not all(math.isfinite(v) for v in trace + [final, tr1.item()]):
            fail(f"{fam} {name}: non-finite loss {trace}, {final}")
        # The descent is held on the run's lowest loss. At the recipe's
        # alpha (0.02) on seeded random weights the loss alternates between
        # a high and a low level from step to step (phase 5's FFHQ trace
        # too), so the final iterate lies below the start only when the
        # step count's parity lands on the low level; church's spatial run
        # rose on its first step and ended above its start. That the
        # gradient points downhill is held by phase 4 (each family's 32^2
        # gradients, card against CPU) and by the CPU tests (a step against
        # the JAX package's).
        if not min(trace[1:] + [final]) < trace[0]:
            fail(f"{fam} {name}: no iterate lowered the loss below the start: {trace} -> "
                 f"{final}")
        return per_step, ms, peak, trace, final, adv, g

    torch.cuda.synchronize()
    reset_counts()
    t_phase = time.perf_counter()

    # (a) fused forwards and arithmetic fusion PGD
    fused_fn = make_fused_image_fn(pipe)
    with torch.no_grad():
        fused_fn(inputs)  # warm-up
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(FAMILY_FWD):
            fused = fused_fn(inputs)
        torch.cuda.synchronize()
        out["fused_forward_ms"] = (time.perf_counter() - t) * 1e3 / FAMILY_FWD
    runs["forwards"] = _diff(read_counts(), before)
    if not _fuse_ok(torch, fused, size=size):
        fail(f"{fam} fused image has shape {tuple(fused.shape)} or non-finite values")
    per_step, ms, peak, trace, final, _, g = pgd_run(FusionAttackConfig(), "arithmetic PGD")
    runs["pgd_step"] = per_step
    out.update(pgd_step_ms=ms, peak_memory_gib=peak, loss_trace=trace, final_loss=final,
               **{k.replace("arithmetic", "pgd", 1): v for k, v in g["numbers"].items()})
    log(f"  {fam}_fused_forward_ms {out['fused_forward_ms']:.3f} [{card}] (N={n}, {size}^2, "
        f"bf16, mean of {FAMILY_FWD})")
    log(f"  {fam}_pgd_step_ms {ms:.3f} [{card}] ({tag}, pixel objective, {FAMILY_STEPS} steps "
        f"after FGSM); {fam}_peak_memory_gib {peak:.3f}; loss {trace} -> {final:.6f}")

    # (b) spatial fusion PGD and the partial-fusion evaluation
    sp_cfg = FusionAttackConfig(mode="spatial", objective="vgg")
    with torch.no_grad():
        sp_fused = make_fused_image_fn(pipe, "spatial")(inputs)
    if not _fuse_ok(torch, sp_fused, size=size):
        fail(f"{fam} spatial fused image has shape {tuple(sp_fused.shape)} or non-finite values")
    per_step, ms, peak, trace, final, adv, g = pgd_run(sp_cfg, "spatial PGD")
    runs["spatial_step"] = per_step
    out.update(spatial_pgd_step_ms=ms, spatial_peak_memory_gib=peak, spatial_loss_trace=trace,
               spatial_final_loss=final, **g["numbers"])
    with torch.no_grad():
        clean, attacked = pipe.get_latents(inputs), pipe.get_latents(adv)
        benign = {m: benign_fusion(pipe.drawer, clean, m) for m in FUSION_MODES}

        def evaluate():
            return {m: (part, fused_image_metrics(pipe, benign[m][0], part))
                    for m in FUSION_MODES
                    for part in [partial_adv_fusion(pipe.drawer, clean, attacked, m)]}

        before = read_counts()
        evaluate()
        runs["eval"] = _diff(read_counts(), before)
        torch.cuda.synchronize()
        t = time.perf_counter()
        evaluated = evaluate()
        torch.cuda.synchronize()
        out["partial_eval_ms"] = (time.perf_counter() - t) * 1e3
    metrics = {}
    for m, (part, (mse, vgg, ssim)) in evaluated.items():
        if not (_fuse_ok(torch, part, n + 1, size) and _fuse_ok(torch, benign[m][0], size=size)):
            fail(f"{fam} {m} partial fusion {tuple(part.shape)} misshapen or non-finite")
        for name, v in (("singles", benign[m][1]), ("mse", mse), ("vgg", vgg), ("ssim", ssim)):
            if not torch.isfinite(v).all():
                fail(f"{fam} {m} evaluation: non-finite {name}")
        if not bool(((ssim >= -1) & (ssim <= 1)).all()):
            fail(f"{fam} {m} SSIM outside [-1, 1]: {ssim.tolist()}")
        metrics[m] = dict(mse=mse.tolist(), vgg=vgg.tolist(), ssim=ssim.tolist())
    out["partial_metrics"] = metrics
    log(f"  {fam}_spatial_pgd_step_ms {ms:.3f} [{card}] ({tag}, 'vgg' objective, "
        f"{FAMILY_STEPS} steps after FGSM); {fam}_spatial_peak_memory_gib {peak:.3f}; "
        f"loss {trace} -> {final:.6f}")
    log(f"  {fam}_partial_eval_ms {out['partial_eval_ms']:.3f} [{card}] (partial fusions, "
        f"batch {n + 1}, and their metrics, both modes); spatial ssim "
        f"{metrics['spatial']['ssim']}")

    # (c) the white-box attack
    wcfg = WhiteboxConfig(lr=WB_LR, n_iters=FAMILY_STEPS, weights=PRESET_ATTACK_MAIN)
    run_whitebox(pipe, inputs, target, dataclasses.replace(wcfg, n_iters=1))  # warm-up
    wb_attack = make_per_image_whitebox(pipe, wcfg)
    wb_eager = lambda: run_eager(pipe, wcfg, inputs, target, per_image=True)  # noqa: E731
    (wb_adv, wb_trace), g = graphed_timing(torch, lambda: wb_attack(inputs, target), wb_attack,
                                           FAMILY_STEPS, eager=wb_eager, what=f"{fam} white-box")
    log_graph(card, f"{fam} whitebox", g)
    ms, peak, runs["whitebox"] = g["step_ms"] * FAMILY_STEPS, g["peak_gib"], g["counts"]
    log(f"  -- {fam} white-box: one step (a graph replay) under torch.profiler")
    profiles["whitebox"] = profile_step(torch, replay_step(list(wb_attack.programs)[0]),
                                        step_ms=g["step_ms"], what=f"{fam} whitebox step ms")
    with uncounted():  # the timed graphs against their eager twin
        hold = g["hold"]()
    out.update(graph_numbers("whitebox", g, hold))
    wb_attack.programs.release()
    hold_graphs(f"{fam} white-box", g, hold)
    totals = wb_trace["total"].float().cpu()
    moved = (wb_adv - inputs).abs().max().item()
    adam_bound = FAMILY_STEPS * WB_LR * (1 - B1) / math.sqrt(1 - B2)
    if tuple(wb_adv.shape) != tuple(inputs.shape):
        fail(f"{fam} white-box adv has shape {tuple(wb_adv.shape)}")
    for k, v in wb_trace.items():
        if tuple(v.shape) != (n, FAMILY_STEPS) or not torch.isfinite(v).all():
            fail(f"{fam} white-box trace {k}: shape {tuple(v.shape)} or non-finite values")
    if not (torch.isfinite(wb_adv).all() and 0 < moved <= adam_bound + 1e-6):
        fail(f"{fam} white-box pixels moved {moved}, expected in (0, {adam_bound}]")
    out.update(whitebox_step_ms=ms / FAMILY_STEPS, whitebox_peak_memory_gib=peak,
               whitebox_total_trace=totals.tolist(), whitebox_moved_max=moved)
    log(f"  {fam}_whitebox_step_ms {ms / FAMILY_STEPS:.3f} [{card}] ({tag}, {FAMILY_STEPS} of "
        f"the preset's {ITER_DICT[size]} iterations, lr {WB_LR}, reference bundle included); "
        f"{fam}_whitebox_peak_memory_gib {peak:.3f}; pixels moved at most {moved:.6e} (Adam "
        f"bound {adam_bound:.6e}); totals {totals.tolist()}")

    # (d) patch training, one epoch
    pcfg = PatchConfig(patch_frac=AttackRunConfig().patch_size, max_count=FAMILY_PATCH_COUNT)
    train = torch.rand((1, size, size, 3), generator=gen, device="cuda") * 2 - 1
    make_patch_attack_step(pipe, dataclasses.replace(pcfg, max_count=1))(
        train, init_patch_square(size, pcfg.patch_frac, gen), gen)  # warm-up
    (canvas, mask), ms, peak = _timed(torch, lambda: train_patch(pipe, [train], gen, pcfg))
    inside = mask[:, :, 0] > 0
    side = int(inside.any(dim=0).sum().item())
    lo, hi = train.min().item(), train.max().item()
    if not (bool(torch.isfinite(canvas).all()) and bool((canvas[mask == 0] == 0).all())
            and lo <= canvas[inside].min().item() and canvas[inside].max().item() <= hi):
        fail(f"{fam} patch: the canvas is not finite, not zero outside its mask, or leaves the "
             f"image's range [{lo}, {hi}]")
    out.update(patch_inner_step_ms=ms / FAMILY_PATCH_COUNT, patch_peak_memory_gib=peak,
               patch_side=side)
    log(f"  {fam}_patch_inner_step_ms {ms / FAMILY_PATCH_COUNT:.3f} [{card}] (square {side}^2 "
        f"at patch_size {pcfg.patch_frac}, one epoch of 1 image x {FAMILY_PATCH_COUNT} inner "
        f"steps); {fam}_patch_peak_memory_gib {peak:.3f}")

    # (e) the family's surrogate classifier: classifier PGD, and CW for car
    clf_fn, model = runner.classifier_for(pipe, AttackRunConfig(dataset_name=fam),
                                          torch.Generator().manual_seed(12))
    with torch.no_grad():
        logits = clf_fn(model, inputs)
    labels = logits.argmax(-1)

    def ce(adv_, model_, labels_):
        return F.cross_entropy(clf_fn(model_, adv_).float(), labels_)

    ccfg = PGDConfig(eps=CLF_EPS, alpha=CLF_ALPHA, steps=FAMILY_STEPS)
    make_pgd(ce, dataclasses.replace(ccfg, steps=1))(inputs, gen, model, labels)  # warm-up
    cpgd = make_pgd(ce, ccfg)

    def c_eager():
        return pgd_eager(ce, ccfg, inputs, pgd_random_start(inputs, seeded(15), ccfg), model,
                         labels)

    (cadv, ctrace), g = graphed_timing(
        torch, lambda: cpgd(inputs, seeded(15), model, labels), cpgd, FAMILY_STEPS,
        eager=c_eager, what=f"{fam} classifier PGD", atol=GRAPH_ATOL["classifier"])
    log_graph(card, f"{fam} classifier pgd", g)
    ms, peak, runs["classifier_pgd"] = g["step_ms"] * FAMILY_STEPS, g["peak_gib"], g["counts"]
    with uncounted():  # the timed graphs against their eager twin
        hold = g["hold"]()
    out.update(graph_numbers("classifier_pgd", g, hold))
    cpgd.programs.release()
    hold_graphs(f"{fam} classifier PGD", g, hold)
    _check_pgd_run(torch, f"{fam} classifier PGD", inputs, cadv, ctrace)
    kind = type(model).__name__
    out.update(classifier_pgd_step_ms=ms / FAMILY_STEPS, classifier_pgd_peak_memory_gib=peak)
    log(f"  {fam}_classifier_pgd_step_ms {ms / FAMILY_STEPS:.3f} [{card}] ({kind}, "
        f"{logits.shape[-1]} labels, {tag}, {FAMILY_STEPS} steps); peak "
        f"{peak:.3f} GiB; CE {ctrace[0].item():.6f} -> {ctrace[-1].item():.6f}")
    if fam == "car":
        cw = make_cw(lambda im, m: clf_fn(m, im), CWConfig(steps=FAMILY_STEPS))
        make_cw(lambda im, m: clf_fn(m, im), CWConfig(steps=1))(inputs, labels, model)

        def cw_twin():
            return cw_eager(lambda im, m: clf_fn(m, im), CWConfig(steps=FAMILY_STEPS), inputs,
                            labels, model)

        (best_adv, best_l2), g = graphed_timing(
            torch, lambda: cw(inputs, labels, model), cw, FAMILY_STEPS, eager=cw_twin,
            what=f"{fam} CW", atol=GRAPH_ATOL["classifier"])
        log_graph(card, f"{fam} cw", g)
        ms, peak, runs["cw"] = g["step_ms"] * FAMILY_STEPS, g["peak_gib"], g["counts"]
        with uncounted():  # the timed graphs against their eager twin
            hold = g["hold"]()
        out.update(graph_numbers("cw", g, hold))
        cw.programs.release()
        hold_graphs(f"{fam} CW", g, hold)
        short = cw_bookkeeping_failures(torch, inputs, best_adv, best_l2, f"{fam} CW")
        if short:
            fail("; ".join(short))
        out.update(cw_step_ms=ms / FAMILY_STEPS, cw_peak_memory_gib=peak,
                   cw_successes=int(torch.isfinite(best_l2).sum()))
        log(f"  {fam}_cw_step_ms {ms / FAMILY_STEPS:.3f} [{card}] ({kind}, c 1e-4, {tag}, "
            f"{FAMILY_STEPS} steps); peak {peak:.3f} GiB; successes {out['cw_successes']} "
            f"(best iterates true)")
    del model

    # (f) attack_run with the family's preset, then invert (car) and fuse
    work = os.path.join(HERE, "runs", "chip_smoke", f"cli_{fam}")
    shutil.rmtree(work, ignore_errors=True)
    images = os.path.join(work, "images")
    os.makedirs(images)
    pixels = ((inputs + 1) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    for i, img in enumerate(pixels):
        Image.fromarray(img).save(os.path.join(images, f"img_{i}.png"))
    save = os.path.join(work, "runs")
    argv = ["--config", os.path.join(HERE, "configs", f"{fam}_whitebox.json"),
            "--images_dir", images, "--attacks", *FAMILY_CLI_ATTACKS, "--pgd_steps",
            str(FAMILY_CLI_STEPS), "--n_iters", str(FAMILY_CLI_STEPS), "--max_num_fusion", "1",
            "--save_dir", save]
    log(f"  python -m tpufusion_torch.cli.attack_run {' '.join(argv)}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    before = read_counts()
    audit_s = AUDIT.seconds if AUDIT is not None else 0.0
    rc, ms, peak = _timed(torch, lambda: attack_run.main(argv))
    audit_s = (AUDIT.seconds if AUDIT is not None else 0.0) - audit_s
    runs["cli"] = _diff(read_counts(), before)
    if rc != 0:
        fail(f"{fam} attack_run returned {rc}")
    bad = cli_run_failures(os.path.join(save, fam), FAMILY_CLI_ATTACKS, n, size,
                           pgd_attacks=FAMILY_CLI_PGD, dataset=fam)
    if bad:
        fail("; ".join(bad))
    out.update(cli_run_s=ms / 1e3, cli_audit_s=audit_s,
               cli_peak_memory_gib=peak - base / 2 ** 30)
    log(f"  {fam}_cli_run_s {ms / 1e3:.3f} [{card}] (pipeline build, {n} images loaded, "
        f"{', '.join(FAMILY_CLI_ATTACKS)} at {FAMILY_CLI_STEPS} steps with their evaluations "
        f"and artifacts; of it {audit_s:.3f} s the launch audit's profiled first replays); "
        f"{fam}_cli_peak_memory_gib {out['cli_peak_memory_gib']:.3f}")
    if fam == "car":
        two = os.path.join(work, "two")
        os.makedirs(two)
        for i in range(INVERT_N):
            shutil.copy(os.path.join(images, f"img_{i}.png"), two)
        inv = os.path.join(work, "invert")
        if invert.main(["--images_dir", two, "--dataset", fam, "--batch", str(INVERT_N),
                        "--save_dir", inv]) != 0:
            fail("invert --dataset car returned non-zero")
        with np.load(os.path.join(inv, "latents.npz")) as f:
            lat = f["latents"]
        sizes = [Image.open(os.path.join(inv, "inversions", p)).size
                 for p in sorted(os.listdir(os.path.join(inv, "inversions")))]
        crop = (size, size * (448 - 64) // 512)  # (width, height): rows 64:448 of 512
        if lat.shape != (INVERT_N, pipe.generator.n_latent, 512) or not np.isfinite(lat).all() \
                or sizes != [crop] * INVERT_N:
            fail(f"invert --dataset car wrote latents {lat.shape} and inversions {sizes}, "
                 f"expected {crop} each")
        log(f"  invert --dataset car: latents {lat.shape}, inversions {sizes} (width, height)")
    demo = os.path.join(work, "fused_demo.jpg")
    if fuse.main(["--dataset", fam, "--out", demo]) != 0 or not os.path.isfile(demo):
        fail(f"fuse --dataset {fam} wrote no montage")
    if Image.open(demo).size != _montage_size(size):
        fail(f"fuse --dataset {fam} wrote a montage of {Image.open(demo).size}, expected "
             f"{_montage_size(size)}")
    log(f"  fuse --dataset {fam}: {Image.open(demo).size} montage (5 parts and the fusion)")
    shutil.rmtree(work, ignore_errors=True)

    launches = read_counts()
    runs["all"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    out["profiles"] = profiles
    short = family_launch_failures(fam, plan, runs)
    if short:
        fail("; ".join(short))
    log(f"  launches {launches} (per synthesis forward: styled_conv {per_fwd}; per arithmetic "
        f"PGD step {runs['pgd_step']}; per spatial PGD step {runs['spatial_step']}; white-box "
        f"{runs['whitebox']}; classifier PGD {runs['classifier_pgd']}"
        + (f"; CW {runs['cw']}" if "cw" in runs else "") + f"; attack_run {runs['cli']}); "
        f"phase 5h {fam} {out['phase_s']:.1f} s [{card}]")
    del pipe
    torch.cuda.empty_cache()
    return launches, runs["pgd_step"], {f"{fam}_{k}": v for k, v in out.items()}


# ---------------------------------------------------------------------------
# phase 6: where the time goes
# ---------------------------------------------------------------------------


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
KERNEL_NAMES = (("conv3x3_wgmma_kernel<true", "styled_conv bf16"),
                ("styled_conv_up_wgmma_kernel", "styled_conv_up bf16"),
                ("styled_conv_bwd_wgmma_kernel<false", "styled_conv_bwd K1"),
                ("styled_conv_bwd_wgmma_kernel<true", "styled_conv_up_bwd K1"),
                ("styled_conv_dgrad_wgmma_kernel", "styled_conv backward K2"),
                ("conv3x3_wgmma_kernel<false", "conv3x3_fwd/dgrad bf16"),
                ("conv3x3_fwd_kernel<float, true>", "styled_conv fp32"),
                ("conv3x3_fwd_kernel<float, false>", "conv3x3_fwd/dgrad fp32"),
                ("conv3x3_wgrad_wgmma_kernel", "conv3x3_wgrad bf16"),
                ("conv3x3_wgrad_kernel", "conv3x3_wgrad fp32"),
                ("sum_partials_kernel", "conv3x3_wgrad second pass"),
                ("PgdOp", "pgd_update"),
                ("AdamOp", "fused_adam"))


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
    shown by its ``WgTile`` / ``WgradTile`` arguments."""
    rows, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_ZN(?:2tf|9tf_stream)(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            name, rest = m.group(2)[:n], m.group(2)[n:]
            tile = re.search(r"(WgTile|WgradTile)I((?:L[ib]\d+E)+)", rest)
            if tile:
                args = ", ".join(re.findall(r"L[ib](\d+)E", tile.group(2)))
                if tile.group(1) == "WgradTile" or not rest.startswith("ILb"):
                    kind = ""
                elif name == "styled_conv_bwd_wgmma_kernel":  # K1's bool: the up conv's
                    kind = "up, " if rest.startswith("ILb1") else "conv, "
                else:
                    kind = "styled, " if rest.startswith("ILb1") else "plain, "
                name += f"<{kind}{tile.group(1)}<{args}>>"
            elif rest.startswith("I"):
                dtype = "float" if rest[1] == "f" else "bf16"
                unroll = re.search(r"Li(\d+)E+v", rest) if name == "stream_reg_kernel" else None
                name += (f"<{dtype}{', styled' if rest[2:6] == 'Lb1E' else ''}"
                         f"{f', U={unroll.group(1)}' if unroll else ''}>")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


# The bf16 conv kernels' SASS: Hopper's warpgroup MMA (HGMMA) and tensor
# copies (UTMALDG) in the forward (every tile class, both libraries), the
# styled convs' backward pair (styled_conv's library) and the weight grad
# (conv3x3's library), and no mma.sync (HMMA) left
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "HMMA")
SASS_KERNELS = {"styled_conv": ("conv3x3_wgmma_kernel", "styled_conv_bwd_wgmma_kernel",
                                "styled_conv_dgrad_wgmma_kernel"),
                "conv3x3": ("conv3x3_wgmma_kernel", "conv3x3_wgrad_wgmma_kernel")}


def sass_counts(text: str):
    """``{kernel: {op: count}}`` of the bf16 conv kernels (the names of
    ``SASS_KERNELS``, by mangled name) in ``cuobjdump -sass`` output,
    counting the ``SASS_OPS`` instructions."""
    names = {k for kernels in SASS_KERNELS.values() for k in kernels}
    out = {}
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name = body.split("\n", 1)[0].strip()
        if any(k in name for k in names):
            out[name] = {op: len(re.findall(rf"\b{op}\b", body)) for op in SASS_OPS}
    return out


def sass_failures(counts, expected=SASS_KERNELS["conv3x3"]):
    """What the bf16 conv kernels' SASS lacks: each of ``expected`` must be
    there, and each kernel must issue HGMMA and UTMALDG and no HMMA."""
    missing = [f"no {k} in the SASS" for k in expected if not any(k in n for n in counts)]
    return missing + [f"{name}: {c}" for name, c in counts.items()
                      if c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"] != 0]


def check_sass(_lib):
    """Phase 2's SASS gate on the styled_conv and conv3x3 libraries
    (``cuobjdump`` beside ``nvcc``)."""
    cuobjdump = os.path.join(os.path.dirname(_lib.nvcc_path()), "cuobjdump")
    failures = []
    for source, expected in SASS_KERNELS.items():
        out = subprocess.run([cuobjdump, "-sass", str(_lib.BUILD_DIR / f"lib{source}.so")],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            fail(f"cuobjdump -sass lib{source}.so failed: {out.stderr.strip()}")
        counts = sass_counts(out.stdout)
        for name, c in counts.items():
            kernel = next(k for k in expected if k in name)
            tile = re.search(r"(WgTile|WgradTile)I((?:L[ib]\d+E)+)", name)
            args = ", ".join(re.findall(r"L[ib](\d+)E", tile.group(2))) if tile else "?"
            log(f"  {source}.cu {kernel}<{tile.group(1) if tile else '?'}<{args}>> SASS: "
                + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))
        failures += [f"lib{source}.so {f}" for f in sass_failures(counts, expected)]
    if failures:
        fail("bf16 conv SASS without wgmma / TMA, or with mma.sync: " + "; ".join(failures))


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke test of tpufusion_torch on the card.")
    parser.add_argument("--kernels-only", action="store_true",
                        help="run phases 1-3 (build, kernels against their plain versions, "
                             "their times) and stop, with no result line")
    parser.add_argument("--first-calls", action="store_true",
                        help="build the kernels, then time each attack the runner dispatches "
                             "at its config's step count on a new attack object against its "
                             "eager twin, and stop, with no result line")
    args = parser.parse_args(argv)
    kernels_only = args.kernels_only
    if not os.path.isfile(os.path.join(HERE, "tpufusion_torch", "__init__.py")):
        fail("tpufusion_torch/ not found beside chip_smoke.py: run it from a checkout")
    # CUPTI torn down after each torch.profiler session: left on, it slows
    # every later graph replay on the host and the device, and this script
    # profiles between timings
    os.environ["TEARDOWN_CUPTI"] = "1"
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

    floor_build = start_floor_build(_lib)
    secs = _lib.build()
    floor_lib = finish_floor_build(*floor_build)
    log(f"  built {', '.join(_lib.SOURCES)} in {secs:.2f} s -> {_lib.BUILD_DIR}")
    for source in _lib.SOURCES:
        for kernel, regs, spill in ptxas_summary(
                (_lib.BUILD_DIR / f"{source}.ptxas.txt").read_text()):
            log(f"  {source}.cu {kernel}: {regs} registers, {spill} bytes spilled")
        for line in (_lib.BUILD_DIR / f"{source}.ptxas.txt").read_text().splitlines():
            if "wgmma.mma_async instructions are serialized" in line:
                log(f"  {source}.cu ptxas: {line.strip()[:200]}")
    check_sass(_lib)
    out_dir = os.path.join(HERE, "runs", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    if args.first_calls:
        log("== first calls: each dispatched attack at its config's steps, FFHQ 1024^2, N=5")
        first = run_first_calls(torch, card)
        with open(os.path.join(out_dir, "first_calls.json"), "w") as f:
            json.dump(dict(card=card, first_calls=first), f, indent=1)
        log(card)
        return

    log("== 3. kernels against their plain versions")
    records = []
    floor = launch_floor(torch, floor_lib, card)
    check_kernels(torch, records, floor)
    if kernels_only:
        with open(os.path.join(out_dir, "chip_smoke_kernels.json"), "w") as f:
            json.dump(dict(card=card, floor=floor, records=records), f, indent=1)
        log(card)
        return

    log("== 4. small-input reference (card vs CPU)")
    check_small_reference(torch)

    # from here on every step program's first replay is profiled and its
    # kernel launches counted (LaunchAudit): the counts of the main paths
    # read each replay at its measured counts
    global AUDIT
    AUDIT = LaunchAudit(torch).install()

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
    two = dataclasses.replace(cfg, pgd=dataclasses.replace(cfg.pgd, steps=2))
    pgd_step = make_fusion_attack(pipe, two)
    pgd_step(inputs, target, gen)
    log("== 6. where the time goes: one PGD step (a graph replay) under torch.profiler")
    profile = profile_step(torch, replay_step(list(pgd_step.programs)[0]),
                           step_ms=main_numbers["pgd_step_ms"], what="pgd_step_ms")
    pgd_step.programs.release()
    log("== 6b. where the time goes: one white-box step (a graph replay) under torch.profiler")
    wb_attack = wb_step()
    wb_profile = profile_step(torch, replay_step(list(wb_attack.programs)[0]),
                              step_ms=main_numbers["whitebox_step_ms"], what="whitebox_step_ms")
    wb_attack.programs.release()
    log("== 6c. where the time goes: one spatial PGD step (a graph replay) under "
        "torch.profiler; the blender")
    sp_cfg, sp_inputs, sp_target, sp_gen = sp_args
    sp_step = make_fusion_attack(pipe, dataclasses.replace(
        sp_cfg, pgd=dataclasses.replace(sp_cfg.pgd, steps=2)))
    sp_step(sp_inputs, sp_target, sp_gen)
    sp_profile = profile_step(torch, replay_step(list(sp_step.programs)[0]),
                              step_ms=main_numbers["spatial_pgd_step_ms"],
                              what="spatial_pgd_step_ms")
    sp_step.programs.release()
    release_cache(torch)
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
        getattr(run, "release", lambda: None)()
    del cl_step
    release_cache(torch)

    # after the main paths, so that a training-style backward's allocations
    # and cuDNN plans leave their times and peak memories as they were
    log("== 3b. the weight grad through styled_conv's and the generator's backward")
    chain = check_weight_grad_chain(torch)

    # after every earlier phase, so that their numbers read as before
    log("== 5f. the attack_run CLI at FFHQ 1024^2: 5 faces on disk, --align, "
        f"{', '.join(CLI_ATTACKS)}, full width; invert and fuse at --tiny")
    cli_launches, cli_numbers = run_cli_path(torch, card)
    main_numbers.update(cli_numbers)

    log("== 5g. scale-out at FFHQ 1024^2 on a one-rank NCCL mesh: the sharded routes against "
        "the single-device routes, the DCP resume, the exported serving programs")
    sh_launches, sh_numbers = run_sharded_path(torch, card, attack_args[0])
    main_numbers.update(sh_numbers)

    # after every earlier phase, so that their numbers read as before
    log("== 5h. car 512^2 (N=4) and church 256^2 (N=3) at published widths: fusion PGD, "
        "spatial PGD and evaluation, white-box, patch, classifier transfer, attack_run")
    family_runs = {}
    for fam in FAMILY_STYLED:
        fam_launches, fam_per_step, fam_numbers = run_family_path(torch, card, fam)
        family_runs[fam] = (fam_launches, fam_per_step)
        main_numbers.update(fam_numbers)

    kernels = summarize(records, {"pgd": (launches, per_step),
                                  "whitebox": (wb_launches, wb_per_step),
                                  "spatial": (sp_launches, sp_per_step),
                                  "patch": (pa_launches, pa_per_step),
                                  "classifier": (cl_launches, cl_per_step),
                                  "cli": (cli_launches, None),
                                  **{run: (c, None) for run, c in sh_launches.items()},
                                  **family_runs})
    main_numbers["launch_audit_s"] = AUDIT.seconds
    with open(os.path.join(out_dir, "chip_smoke_kernels.json"), "w") as f:
        json.dump(dict(card=card, floor=floor, records=records, kernels=kernels,
                       main=main_numbers,
                       profile=profile, whitebox_profile=wb_profile,
                       spatial_profile=sp_profile,
                       patch_profile=pa_profile, classifier_profile=cl_profile,
                       weight_grad_chain=chain), f, indent=1)
    log(f"  the launch audit profiled {AUDIT.audited} step programs' first "
        f"replays in {AUDIT.seconds:.1f} s, each replay's kernel launches equal to its "
        f"program's count")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

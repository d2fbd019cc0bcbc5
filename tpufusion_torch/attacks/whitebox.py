"""White-box pixel attack (``optimize_vgg``; port of
``tpufusion/attacks/whitebox.py``).

Reference semantics (`attack_main2.py:584-671`, variant
`interpolation.py:743-843`): Adam on the input pixels against a multi-term
objective combining

  - encoder-latent distance to the target / away from the original,
  - decoder-reconstruction distance to the target image,
  - VGG perceptual distances (4-tap MSE sums),
  - pixel distance to the original image.

The loss encodes and decodes with *raw* e4e codes (no ``latent_avg`` offset
and no cars trim), as the reference's white-box loop does; the fusion attack
is the other way round. The no-grad reference bundle (target and original
latents and VGG taps) is computed once; each iteration is one forward
(encoder, decoder, two VGG passes, 8 MSE terms), one backward to the pixels
and one Adam step, the fused ``ops.adam_update.fused_adam`` kernel on the
card.

The JAX package has two executors under ``execution``: ``"scan"``, the
whole loop as one program, and ``"stepwise"``, one jitted step driven by a
host loop. Here both run one step program per ``grad_accum`` chunk
(``core.graphs.StepProgram``: static ``x``, Adam moments and device step
count, a (..., n_iters) trace per term and a device step index; the
reference bundle as static inputs; the chunks' programs share one memory
pool). On the card a program's first step runs eagerly and every later
step replays the step captured once as a CUDA graph. ``"scan"`` reads
nothing on the host until the loop ends (snapshot frames stay on the
device); ``"stepwise"`` moves each snapshot frame to the host as it comes.
``run_eager``, the Python loop, is the programs' plain twin.

Two semantics, as in the JAX package:
- ``make_whitebox_attack`` / ``run_whitebox_stepwise``: the batch is one
  problem and each term is a mean over the batch;
- ``make_per_image_whitebox`` (JAX's ``vmap_whitebox`` /
  ``vmap_whitebox_stepwise``) and ``run_whitebox``: every image has its own
  Adam trajectory. The N images run as one batch and the backward takes the
  sum over images of each image's total, so each image's gradient is that of
  its own loss (a batch mean would scale it by 1/N, which Adam's eps does
  not cancel). Its traces have shape (B, n_iters) per term.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpufusion_torch.core.graphs import ProgramCache, StepProgram, signature, static_copy
from tpufusion_torch.core.imaging import avg_pool
from tpufusion_torch.ops.adam_update import adam_init, fused_adam
from tpufusion_torch.pipeline import FusionPipeline


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Coefficients of the 8 loss terms; positive pulls toward, the
    ``latent_org`` term enters negated in the presets (push away)."""

    latent_target: float = 0.0
    latent_org: float = 0.0
    img_rec_target: float = 0.0
    img_rec_org: float = 0.0
    img_org: float = 0.0
    lpips_img: float = 0.0
    lpips_rec_target: float = 0.0
    lpips_rec_org: float = 0.0


# `attack_main2.py:649`:
#   10*l_latent_target + l_img_rec_target - l_latent_org + 20*l_img_org + l_lpips_img
PRESET_ATTACK_MAIN = LossWeights(
    latent_target=10.0, img_rec_target=1.0, latent_org=-1.0, img_org=20.0,
    lpips_img=1.0,
)

# `interpolation.py:818`:
#   (10*l_latent_target - l_latent_org) + (l_img_rec_target + 0.1*l_lpips_rec_target)
#   + (10*l_img_org + l_lpips_img)
PRESET_INTERPOLATION = LossWeights(
    latent_target=10.0, latent_org=-1.0, img_rec_target=1.0,
    lpips_rec_target=0.1, img_org=10.0, lpips_img=1.0,
)


EXECUTIONS = ("scan", "stepwise")


@dataclasses.dataclass(frozen=True)
class WhiteboxConfig:
    lr: float = 1e-4  # reference default (`attack_main2.py:879`)
    n_iters: int = 100  # iter_dict 100 @1024/512, 50 @256 (`attack_main2.py:908`)
    weights: LossWeights = PRESET_ATTACK_MAIN
    # When set, the per-image attack also returns snapshots {adv_input, rec}
    # taken with the reference's ``args.save_img`` cadence
    # (`attack_main2.py:657-661`): frame k after k*every + 1 steps, never
    # after the final step; host numpy when the attack returns.
    snapshot_every: Optional[int] = None
    # Split the batch into ``grad_accum`` sequential chunks per iteration:
    # only one chunk's forward/backward activations are live at a time,
    # while the whole batch's pixels and Adam moments stay resident.
    # Per-image trajectories are independent, so this changes nothing but
    # reduction order. Per-image attack only.
    grad_accum: int = 1
    # Both executors run the same step program and walk the grad_accum
    # chunks; this decides only where the snapshot frames go. 'scan': they
    # stay on the device and nothing is read on the host until the loop
    # ends; 'stepwise': each frame moves to the host as it comes
    execution: str = "scan"

    def __post_init__(self):
        if self.execution not in EXECUTIONS:
            raise ValueError(f"execution must be one of {EXECUTIONS}, got {self.execution!r}")


def default_n_iters(image_size: int) -> int:
    """The reference's ``iter_dict = {1024:100, 512:100, 256:50}``."""
    return 50 if image_size <= 256 else 100


TERMS = tuple(f.name for f in dataclasses.fields(LossWeights))


def _mse(a, b):
    """Per-image mean squared difference in float32, shape (B,)."""
    d = a.float() - b.float()
    return (d * d).flatten(1).mean(dim=1)


def _perceptual(feats_a, feats_b):
    """Per-image ``perceptual_distance``: the sum of per-tap MSEs, (B,)."""
    return sum(_mse(a, b) for a, b in zip(feats_a, feats_b))


def _make_loss(pipeline: FusionPipeline, weights: LossWeights, *, per_image: bool = False):
    """``loss(x, ref) -> (total, terms)``. All 8 terms are computed (for the
    trace); only those with a non-zero weight enter ``total``. Each is a
    mean over the batch, or with ``per_image`` a (B,) vector of per-image
    means."""
    factor = pipeline.pool_factor
    w = weights
    rec_feats_grad = w.lpips_rec_target != 0.0 or w.lpips_rec_org != 0.0

    def loss_fn(x, ref):
        r_x = avg_pool(x, factor)
        latent_pred = pipeline.encoder(r_x)
        img_rec = pipeline.decode(latent_pred)
        # unless a lpips_rec term is weighted, the VGG pass over the
        # reconstruction only feeds the trace and needs no graph
        with torch.set_grad_enabled(torch.is_grad_enabled() and rec_feats_grad):
            feats_rec = pipeline.vgg(avg_pool(img_rec, factor))
        feats_x = pipeline.vgg(r_x)
        terms = dict(
            latent_target=_mse(ref["latent_target"], latent_pred),
            latent_org=_mse(ref["latent_org"], latent_pred),
            img_rec_target=_mse(ref["target"], img_rec),
            img_rec_org=_mse(ref["img_org"], img_rec),
            img_org=_mse(ref["img_org"], x),
            lpips_img=_perceptual(feats_x, ref["feats_org"]),
            lpips_rec_target=_perceptual(feats_rec, ref["feats_target"]),
            lpips_rec_org=_perceptual(feats_rec, ref["feats_org"]),
        )
        if not per_image:
            terms = {k: v.mean() for k, v in terms.items()}
        total = sum(getattr(w, k) * v for k, v in terms.items() if getattr(w, k) != 0.0)
        return total, terms

    return loss_fn


def _make_ref(pipeline: FusionPipeline):
    """The no-grad reference bundle: the original and target images, their
    raw latents and VGG taps (`attack_main2.py:596-603`)."""
    factor = pipeline.pool_factor

    @torch.no_grad()
    def ref_fn(img, target_img):
        r_org = avg_pool(img, factor)
        r_t = avg_pool(target_img, factor)
        return dict(
            img_org=img,
            target=target_img,
            latent_org=pipeline.encoder(r_org),
            latent_target=pipeline.encoder(r_t),
            feats_org=pipeline.vgg(r_org),
            feats_target=pipeline.vgg(r_t),
        )

    return ref_fn


def make_whitebox_stepper(pipeline: FusionPipeline, config: WhiteboxConfig, *,
                          per_image: bool = False):
    """``(init, step)``: ``state = init(img, target)``, ``state, terms =
    step(state)``; the adversarial image is ``state["x"]``, a float32 copy of
    ``img`` that each step updates in place. Terms are batch means, or with
    ``per_image`` (B,) vectors whose sum is what the backward takes.
    ``init(..., on_device=True)`` keeps Adam's step count on the device
    (``adam_init``), as a captured step needs."""
    loss_fn = _make_loss(pipeline, config.weights, per_image=per_image)
    ref_fn = _make_ref(pipeline)

    def init(img, target_img, *, on_device: bool = False):
        x = img.detach().float().clone(memory_format=torch.contiguous_format)
        return dict(x=x, ref=ref_fn(img, target_img), opt_state=adam_init(x, on_device=on_device))

    def step(state):
        x = state["x"].detach().requires_grad_(True)
        total, terms = loss_fn(x, state["ref"])
        (g,) = torch.autograd.grad(total.sum(), x)
        state["x"], state["opt_state"] = fused_adam(
            state["x"], g.contiguous(), state["opt_state"], config.lr)
        terms = {k: v.detach() for k, v in terms.items()}
        terms["total"] = total.detach()
        return state, terms

    return init, step


def _chunks(imgs, targets, accum: int):
    """The batch cut into ``accum`` chunks of ``ceil(b / accum)`` rows,
    padded by wrap: per-image trajectories are independent, so the wrapped
    rows are redundant work sliced off at the end. ``[(imgs, targets)]``."""
    b = imgs.shape[0]
    cb = -(-b // accum)
    if cb * accum != b:
        wrap = torch.arange(cb * accum, device=imgs.device) % b
        imgs = imgs[wrap]
        targets = targets if targets.shape[0] == 1 else targets[wrap]
    cuts = [slice(i * cb, (i + 1) * cb) for i in range(accum)]
    return [(imgs[s], targets if targets.shape[0] == 1 else targets[s]) for s in cuts]


def _drive(pipeline, config, b, n_chunks, advance, xs):
    """The iteration loop shared by the programs and the eager twin:
    ``advance(ci)`` takes chunk ``ci`` one step, ``xs()`` is the chunks'
    pixels. Returns the snapshots (None without ``snapshot_every``):
    ``"stepwise"`` moves each frame to the host as it comes, ``"scan"`` keeps
    them on the device until the loop ends."""
    every = config.snapshot_every
    factor = pipeline.pool_factor
    snaps = []

    @torch.no_grad()
    def frame():
        parts = xs()
        return [torch.cat(parts)[:b], torch.cat(
            [pipeline.decode(pipeline.encoder(avg_pool(x, factor))).float() for x in parts])[:b]]

    for it in range(config.n_iters):
        for ci in range(n_chunks):
            advance(ci)
        # the reference's post-step check at loop index `it`: no frame at
        # k = 0 and none after the final step (`attack_main2.py:657`)
        if every and it % every == 0 and it // every > 0:
            f = frame()
            snaps.append([t.cpu().numpy() for t in f] if config.execution == "stepwise" else f)
    if not every:
        return None
    if not snaps:  # n_iters <= every: the reference writes no frames
        empty = np.zeros((0, b) + tuple(xs()[0].shape[1:]), np.float32)
        return dict(adv_input=empty, rec=empty.copy())
    host = [[t if isinstance(t, np.ndarray) else t.cpu().numpy() for t in f] for f in snaps]
    return dict(adv_input=np.stack([f[0] for f in host]), rec=np.stack([f[1] for f in host]))


def _result(adv, trace, snaps):
    return (adv, trace) if snaps is None else (adv, trace, snaps)


def run_eager(pipeline: FusionPipeline, config: WhiteboxConfig, imgs, targets, *,
              per_image: bool):
    """The plain twin of the white-box programs: the loop in Python over
    ``make_whitebox_stepper``'s step, each step's tensors new, Adam's count
    on the host. ``(adv, trace)`` plus the snapshots when
    ``config.snapshot_every`` is set."""
    init, step = make_whitebox_stepper(pipeline, config, per_image=per_image)
    b = imgs.shape[0]
    states = [init(i, t) for i, t in _chunks(imgs, targets, max(int(config.grad_accum or 1), 1))]
    traces = [[] for _ in states]

    def advance(ci):
        states[ci], terms = step(states[ci])
        traces[ci].append(terms)

    snaps = _drive(pipeline, config, b, len(states), advance, lambda: [s["x"] for s in states])
    trace = {k: torch.cat([torch.stack([t[k] for t in tr], dim=-1) for tr in traces])
             if per_image else torch.stack([t[k] for t in traces[0]])
             for k in traces[0][0]}
    if per_image:
        trace = {k: v[:b] for k, v in trace.items()}
    return _result(torch.cat([s["x"] for s in states])[:b], trace, snaps)


def _program_runner(pipeline: FusionPipeline, config: WhiteboxConfig, *, per_image: bool):
    """``run(imgs, targets)`` over one ``StepProgram`` per chunk, cached by
    the inputs' signature; ``run.programs`` is the cache."""
    init, step = make_whitebox_stepper(pipeline, config, per_image=per_image)
    programs = ProgramCache(fixed=(pipeline,))
    n = config.n_iters

    def body(state, inputs):
        st = dict(x=state["x"], ref=inputs["ref"], opt_state=state["opt"])
        _, terms = step(st)
        for k, v in terms.items():
            state["trace"][k].index_copy_(-1, state["idx"].view(1), v.unsqueeze(-1))
        state["idx"].add_(1)

    def start(img, target):
        st = init(img, target, on_device=True)
        lead = (img.shape[0],) if per_image else ()
        # the terms' dtype: they are float32 (``.float()``), as x is
        trace = {k: torch.zeros(lead + (n,), dtype=st["x"].dtype, device=img.device)
                 for k in TERMS + ("total",)}
        return (dict(x=st["x"], opt=st["opt_state"], trace=trace,
                     idx=torch.zeros((), dtype=torch.int64, device=img.device)),
                dict(ref=st["ref"]))

    def build(starts):
        progs = []
        for state, inputs in starts:
            progs.append(StepProgram(body, static_copy(state), static_copy(inputs), limit=n,
                                     pool_of=progs[0] if progs else None))
        return progs

    def run(imgs, targets):
        b = imgs.shape[0]
        starts = [start(i, t) for i, t in _chunks(imgs, targets,
                                                  max(int(config.grad_accum or 1), 1))]
        progs = programs.get(signature(imgs, targets), lambda: build(starts))
        for prog, (state, inputs) in zip(progs, starts):
            prog.load(state, inputs)
        snaps = _drive(pipeline, config, b, len(progs), lambda ci: progs[ci].run(1),
                       lambda: [p.state["x"] for p in progs])
        trace = {k: torch.cat([p.state["trace"][k] for p in progs]) if per_image
                 else progs[0].state["trace"][k].clone() for k in progs[0].state["trace"]}
        if per_image:
            trace = {k: v[:b] for k, v in trace.items()}
        adv = torch.cat([p.state["x"] for p in progs])[:b]
        return _result(adv, trace, snaps)

    run.programs = programs
    return run


def _no_grad_accum(config: WhiteboxConfig, what: str) -> None:
    if config.grad_accum > 1:
        raise ValueError(
            f"grad_accum > 1 is only supported by the per-image attack "
            f"(run_whitebox): {what} averages the loss over the batch, so "
            f"chunking would change the gradient scale")


def make_whitebox_attack(pipeline: FusionPipeline, config: WhiteboxConfig):
    """Build ``attack(img, target_img) -> (adv_img, trace)`` (plus snapshots
    when ``config.snapshot_every`` is set) on a (1, S, S, 3) image or a
    naturally batched (B, S, S, 3) batch: every term is a mean over the
    batch. ``trace`` maps each term and ``total`` to an (n_iters,) tensor.
    Use ``make_per_image_whitebox`` for per-image trajectories."""
    _no_grad_accum(config, "make_whitebox_attack")
    return _program_runner(pipeline, config, per_image=False)


def run_whitebox_stepwise(pipeline: FusionPipeline, img, target_img,
                          config: WhiteboxConfig):
    """``make_whitebox_attack`` without snapshots, ``(adv, trace)``; kept
    only so the JAX package's entry-point names carry over."""
    return make_whitebox_attack(pipeline, dataclasses.replace(
        config, snapshot_every=None, execution="stepwise"))(img, target_img)


def make_per_image_whitebox(pipeline: FusionPipeline, config: WhiteboxConfig):
    """Per-image attack (JAX's ``vmap_whitebox`` / ``vmap_whitebox_stepwise``):
    ``attack(imgs, targets)`` with ``targets`` either (1, ...) broadcast
    (white_box_target) or per-image (white_box_patch),
    `attack_main2.py:472-482`. Returns ``(adv, trace)``, trace (B, n_iters)
    per term, plus the snapshots {adv_input, rec}, each (K, B, S, S, 3)
    host numpy, when ``config.snapshot_every`` is set. ``attack.programs``
    holds its step programs (``release()`` frees them)."""
    return _program_runner(pipeline, config, per_image=True)


def run_whitebox(pipeline: FusionPipeline, inputs, target_img, config: WhiteboxConfig,
                 which_adv=None):
    """`white_box` of the reference (`attack_main2.py:465-498`): perturb the
    images listed in ``which_adv`` (default: all), keep the rest as they
    are. Returns ``(adv_inputs, traces)``, or ``(adv_inputs, traces, snaps)``
    when ``config.snapshot_every`` is set (snapshot rows are the attacked
    subset, in ``which_adv`` order)."""
    n = inputs.shape[0]
    which = sorted(set(range(n)) if not which_adv else set(which_adv))
    idx = torch.as_tensor(which, device=inputs.device)
    sub_targets = target_img if target_img.shape[0] == 1 else target_img[idx]
    adv_sel, *rest = make_per_image_whitebox(pipeline, config)(inputs[idx], sub_targets)
    adv = inputs.clone()
    adv[idx] = adv_sel.to(adv.dtype)
    return (adv, *rest)


# ---------------------------------------------------------------------------
# the legacy LPIPS-net variants ``optimize`` / ``optimize_copy``
# ---------------------------------------------------------------------------


def _sum_mse(a, b):
    """``nn.MSELoss(reduction='sum')``: the legacy variants use the sum, not
    the mean (`attack_main2.py:684`)."""
    d = a.float() - b.float()
    return (d * d).sum()


@dataclasses.dataclass(frozen=True)
class LegacyOptimizeConfig:
    """Reference ``optimize`` / ``optimize_copy`` (`attack_main2.py:674-762`):
    Adam(lr=0.01) for 1000 iterations on the pixels, the LPIPS-net perceptual
    term, sum-reduction MSEs, a snapshot of the input every 50 iterations."""

    lr: float = 0.01
    n_iters: int = 1000
    variant: str = "optimize"  # or "optimize_copy"
    snapshot_every: int = 50


def _make_legacy_loss(pipeline: FusionPipeline, lpips_model, variant: str):
    """``(ref_fn, loss_fn)`` of a legacy variant: ``ref = ref_fn(img,
    target)``, the no-grad bundle, and ``total, terms = loss_fn(x, ref)``."""
    if variant not in ("optimize", "optimize_copy"):
        raise ValueError(f"unknown legacy variant {variant!r}")
    factor = pipeline.pool_factor
    copy_variant = variant == "optimize_copy"

    @torch.no_grad()
    def ref_fn(img, target_img):
        r_t = avg_pool(target_img, factor)
        latent_target = pipeline.encoder(r_t)
        return dict(img_org=img, target=target_img, r_target=r_t, latent_target=latent_target,
                    target_rec=pipeline.decode(latent_target) if copy_variant else None)

    def loss_fn(x, ref):
        latent_pred = pipeline.encoder(avg_pool(x, factor))
        img_rec = pipeline.decode(latent_pred)
        if copy_variant:
            l_lpips = lpips_model(ref["target"], img_rec)
            l_img_rec = _sum_mse(ref["target_rec"], img_rec)
        else:
            l_lpips = lpips_model(ref["r_target"], avg_pool(img_rec, factor))
            l_img_rec = _sum_mse(ref["target"], img_rec)
        terms = dict(
            img_org=_sum_mse(ref["img_org"], x),
            lpips_rec=l_lpips.sum(),
            latent=_sum_mse(ref["latent_target"], latent_pred),
            img_rec=l_img_rec,
        )
        return sum(terms.values()), terms

    return ref_fn, loss_fn


def make_legacy_optimize(pipeline: FusionPipeline, lpips_model, config: LegacyOptimizeConfig):
    """The legacy LPIPS-net white-box optimizer; ``lpips_model`` is a
    ``models.lpips.LPIPS`` on the pipeline's device.

    Loss (``optimize``, `attack_main2.py:697-708`), with raw codes:
        sumMSE(img_org, x) + LPIPS(pool(target), pool(dec(enc(pool(x)))))
      + sumMSE(latent_target, enc(pool(x))) + sumMSE(target, dec(...))
    ``optimize_copy`` (`:723-753`) scores LPIPS at full resolution and the
    reconstruction against the target's own reconstruction ``target_rec``.
    Each iteration is one forward, one backward to the pixels and one
    ``ops.adam_update.fused_adam`` step (``optax.adam(lr)``'s update).

    Returns ``attack(img, target_img) -> (adv, trace, snapshots)``: ``trace``
    maps ``img_org``, ``lpips_rec``, ``latent``, ``img_rec`` and ``total`` to
    (n_iters,) tensors; ``snapshots`` is host numpy with the rows of the
    reference's ``optimize.png`` (`:689,714-718`): the original image, then
    the pixels after k * snapshot_every + 1 steps for k = 1 ..
    (n_iters - 1) // snapshot_every, leading axis 1 + (n_iters - 1) //
    snapshot_every; zero-length when ``snapshot_every`` is 0 or None."""
    ref_fn, loss_fn = _make_legacy_loss(pipeline, lpips_model, config.variant)
    every = int(config.snapshot_every or 0)

    def host(x):
        return x.detach().float().cpu().numpy()

    def attack(img, target_img):
        ref = ref_fn(img, target_img)
        x = img.detach().float().clone(memory_format=torch.contiguous_format)
        opt_state = adam_init(x)
        # the reference seeds the montage with the original image (`:689`)
        snaps = [host(img)] if every else []
        traces = []
        for it in range(config.n_iters):
            xg = x.detach().requires_grad_(True)
            total, terms = loss_fn(xg, ref)
            (g,) = torch.autograd.grad(total, xg)
            x, opt_state = fused_adam(x, g.contiguous(), opt_state, config.lr)
            terms = {k: v.detach() for k, v in terms.items()}
            terms["total"] = total.detach()
            traces.append(terms)
            # the reference's post-step check at loop index `it` (`:714`)
            if every and it % every == 0 and it > 0:
                snaps.append(host(x))
        trace = {k: torch.stack([t[k] for t in traces]) for k in traces[0]}
        frames = (np.stack(snaps) if snaps else
                  np.zeros((0,) + tuple(img.shape), np.float32))
        return x, trace, frames

    return attack

"""Mesh + sharding rules (port of ``tpufusion/parallel/sharding.py``; the
reference is strictly single-GPU, `attack_main2.py:843`).

PyTorch's idiom replaces JAX's single program over many devices: one
process per device (``torchrun --nproc-per-node N``), a ``torch.distributed``
process group over them, and a ``DeviceMesh`` of shape ``(data, model)``
with the dim names ``("data", "model")``.

Axes:
- ``data``: the batch axis. The attack loops are embarrassingly
  batch-parallel (each image optimises on its own), so every rank takes its
  contiguous slice of the batch, padded to a multiple of the axis by
  wrapping rows from the start, runs the single-device code on it, and the
  result comes back whole on every rank (an all-gather over ``data``);
  callers slice ``[:n_real]`` as the JAX callers do. Where JAX's program
  reduces over the batch (the patch gradient, a loss trace), the ranks
  all-reduce.
- ``model``: tensor parallelism of the generator's weights, as DTensors
  sharded over ``model`` (``shard_generator_params``); the forward gathers
  each weight whole before use, so the kernels keep their shapes.

Inputs are whole on every rank, as the JAX callers pass global arrays, and
every rank draws from generators seeded alike: a random draw is made once
at the unpadded shape and sliced, or split per image or group
(``core.prng.split_generator``), never per rank.
"""

from __future__ import annotations

import dataclasses

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from tpufusion_torch.core.dtypes import resolve_device
from tpufusion_torch.core.prng import split_generator

AXES = ("data", "model")


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def init_process_group(device_type: str) -> None:
    """Join the process group, unless one is initialised: from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and its rendezvous
    address) where it is set, else as a one-rank group on an in-memory
    store, with no network address. NCCL on ``cuda`` (the process's card
    is ``cuda:LOCAL_RANK``), gloo on the CPU. An initialised group on
    another backend raises ``ValueError``."""
    cuda = device_type == "cuda"
    if dist.is_initialized():
        backend = "nccl" if cuda else "gloo"
        if backend not in str(dist.get_backend()):
            raise ValueError(
                f"a {device_type} mesh needs a {backend} process group, but the initialised "
                f"one runs {dist.get_backend()}: destroy it first "
                "(torch.distributed.destroy_process_group)")
        return
    kw = {}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if cuda:
            local = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        dist.init_process_group("nccl" if cuda else "gloo", init_method="env://", **kw)
        return
    if cuda:
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl" if cuda else "gloo", store=dist.HashStore(), rank=0,
                            world_size=1, **kw)


def create_mesh(devices=None, *, data: Optional[int] = None, model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over the processes of the group, one device
    each (where JAX takes a list of devices, the processes are the
    devices). ``devices`` is their device type (``cuda`` unless given;
    ``cpu`` runs gloo). The group is the initialised one, else torchrun's,
    else a one-rank group (``init_process_group``). ``data`` defaults to
    world size // model."""
    device_type = resolve_device(devices).type
    init_process_group(device_type)
    n = dist.get_world_size()
    if n < model:
        raise ValueError(
            f"requested model={model} tensor-parallel shards but only {n} "
            f"device(s) are available ({device_type}); start one process per "
            "device (torchrun --nproc-per-node N) to test multi-device meshes")
    if data is None:
        data = n // model
    if data < 1 or data * model != n:
        raise ValueError(
            f"cannot build a data={data} x model={model} mesh from {n} "
            f"device(s): axis product {data * model} != device count {n}")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def batch_sharding(mesh: DeviceMesh, ndim: int) -> tuple:
    """DTensor placements of a batch over the mesh: the leading axis sharded
    over ``data``, replicated over ``model`` (``ndim`` kept for the JAX
    signature: a placement names the dim it shards)."""
    return (Shard(0), Replicate())


def replicate(mesh: DeviceMesh) -> tuple:
    """DTensor placements of a value every rank holds whole."""
    return (Replicate(), Replicate())


def pad_batch_to_multiple(x, multiple: int):
    """Pad the leading axis up to a multiple by wrapping rows from the
    start; returns ``(padded, n_real)``. The wrapped rows are real inputs
    (not zeros), so every model forward sees in-distribution data, and
    callers slice ``[:n_real]`` afterwards."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    reps = -(-rem // n)  # wrap as many times as needed for tiny batches
    pad = torch.cat([x] * reps, dim=0)[:rem]
    return torch.cat([x, pad], dim=0), n


def data_size(mesh: DeviceMesh) -> int:
    return mesh.size(0)


def data_rows(mesh: DeviceMesh, n_padded: int) -> slice:
    """This rank's contiguous slice of a padded batch of ``n_padded`` rows."""
    d = data_size(mesh)
    if n_padded % d:
        raise ValueError(f"batch of {n_padded} rows is not a multiple of data={d}")
    per = n_padded // d
    r = mesh.get_local_rank("data")
    return slice(r * per, (r + 1) * per)


def local_rows(mesh: DeviceMesh, x):
    """This rank's rows of a padded batch (the form ``jax.device_put`` with
    ``batch_sharding`` takes here)."""
    return x[data_rows(mesh, x.shape[0])]


def gather_rows(mesh: DeviceMesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's rows, whole on every rank (all-gather over ``data``)."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(data_size(mesh))]
    dist.all_gather(parts, local, group=mesh.get_group("data"))
    return torch.cat(parts)


def all_reduce_data(mesh: DeviceMesh, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``data`` (a new tensor, the same on every rank)."""
    t = t.clone()
    dist.all_reduce(t, op=op, group=mesh.get_group("data"))
    return t


def as_dtensors(mesh: DeviceMesh, tree):
    """A nest of this rank's batch rows as DTensors sharded over ``data``
    (the form a checkpoint of sharded state takes); other leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: as_dtensors(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_dtensors(mesh, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return DTensor.from_local(tree, mesh, batch_sharding(mesh, tree.ndim), run_check=False)
    return tree


def to_local(tree):
    """The inverse of ``as_dtensors``: every DTensor leaf's local rows."""
    if isinstance(tree, dict):
        return {k: to_local(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_local(v) for v in tree)
    return tree.to_local() if isinstance(tree, DTensor) else tree


# ---------------------------------------------------------------------------
# tensor parallelism of the generator
# ---------------------------------------------------------------------------


def expected_tp_leaf_count(generator, model_size: int) -> int:
    """How many generator parameters the TP rule MUST shard, derived from
    the module's static structure (``conv_plan``/``n_mlp``), independent of
    parameter names, so ``shard_generator_params`` is verified post hoc."""
    n = 0
    # mapping MLP weights: (style_dim, style_dim)
    if generator.style_dim % model_size == 0:
        n += generator.n_mlp
    # per-conv affine weights: (cin, style_dim)
    n += sum(1 for cin in generator.style_input_dims() if cin % model_size == 0 and cin > 4)
    # modulated conv weights: (1, cout, cin, k, k); to_rgb (cout 3) replicated
    n += sum(1 for _, cout, kind in generator.conv_plan()
             if kind != "rgb" and cout % model_size == 0 and cout > 4)
    return n


def _tp_dim(p: torch.Tensor, model_size: int) -> Optional[int]:
    """The dim the TP rule shards ``p`` on, or None (replicated). The
    predicate is structural (rank + shape), so a renamed module cannot
    silently degrade to replication:
    - rank-2 parameters are the linear weights (out, in), sharded on their
      out-features (biases are 1-D);
    - rank-5 parameters shaped ``(1, cout, cin, k, k)`` with a square 1x1
      or 3x3 kernel are the modulated convs, sharded on cout (to_rgb's cout
      3 fails divisibility; the ``(1, C, 4, 4)`` constant is rank 4 and the
      noise planes are buffers)."""
    if p.ndim == 2 and p.shape[0] % model_size == 0 and p.shape[0] > 4:
        return 0
    if (p.ndim == 5 and p.shape[0] == 1 and p.shape[3] == p.shape[4]
            and p.shape[3] in (1, 3) and p.shape[1] % model_size == 0 and p.shape[1] > 4):
        return 1
    return None


def shard_generator_params(module: torch.nn.Module, mesh: DeviceMesh, generator=None):
    """TP rule: shard the out-features of the linear weights (mapping +
    style affines) and the out-channels of the synthesis conv weights over
    ``model`` as DTensors (each rank keeps its slice, no communication);
    replicate the rest (every rank holds it whole). In place on ``module``,
    which is returned; the forward gathers each sharded weight whole
    (``models.stylegan2.whole``), so the result equals the unsharded one.

    When ``generator`` (the ``Generator``) is passed and ``model`` > 1, the
    count of sharded parameters is checked against
    ``expected_tp_leaf_count`` from the module's static plan, failing loudly
    if the rule ever stops matching the parameters."""
    model_size = mesh.size(1)
    rank = mesh.get_local_rank("model")
    placements = {0: (Replicate(), Shard(0)), 1: (Replicate(), Shard(1))}
    sharded = []
    for name, p in list(module.named_parameters()):
        dim = _tp_dim(p, model_size)
        if dim is None:
            continue
        local = p.detach().chunk(model_size, dim=dim)[rank].contiguous()
        dt = DTensor.from_local(local, mesh, placements[dim], run_check=False,
                                shape=p.shape, stride=p.stride())
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        setattr(owner, leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
        sharded.append(name)
    if generator is not None and model_size > 1:
        expected = expected_tp_leaf_count(generator, model_size)
        if len(sharded) != expected:
            raise ValueError(
                f"TP sharding rule matched {len(sharded)} generator parameters but the "
                f"module's static plan expects {expected} (model={model_size}); "
                f"matched: {sorted(sharded)}")
    return module


# ---------------------------------------------------------------------------
# white-box
# ---------------------------------------------------------------------------


def make_sharded_whitebox_step(pipeline, config, mesh: DeviceMesh):
    """One data-parallel white-box optimisation step over the mesh: each
    rank runs the port's per-image white-box step
    (``attacks.whitebox.make_whitebox_stepper``, ``fused_adam``) on its rows.
    Per-image Adam is independent of the other rows, so the result does not
    depend on the world size.

    Returns ``(step, init, place_batch)``: ``place_batch(imgs, targets)``
    takes this rank's rows of the padded batch, ``init(imgs, targets) ->
    state`` on them, and ``step(state) -> (state, per_image_loss)`` with the
    (B,) loss of every row of the padded batch, gathered."""
    from tpufusion_torch.attacks.whitebox import make_whitebox_stepper

    init, stepper_step = make_whitebox_stepper(pipeline, config, per_image=True)

    def step(state):
        state, terms = stepper_step(state)
        return state, gather_rows(mesh, terms["total"])

    def place_batch(imgs, targets):
        return local_rows(mesh, imgs), local_rows(mesh, targets)

    return step, init, place_batch


def prepare_whitebox_batch(inputs, target_img, which_adv, mesh: DeviceMesh):
    """Shared preamble of the sharded white-box runners: which_adv
    selection, per-image / shared target resolution, pad to the ``data``
    axis. Returns ``(idx, sub_p, targets_p, n_real)``."""
    n = inputs.shape[0]
    which = sorted(set(range(n)) if not which_adv else set(which_adv))
    idx = torch.as_tensor(which, device=inputs.device)
    sub = inputs[idx]
    # per-image targets select the same rows (white_box_patch paste targets);
    # a single shared target broadcasts across the selection
    targets = (target_img.expand_as(sub).contiguous() if target_img.shape[0] == 1
               else target_img[idx])
    sub_p, n_real = pad_batch_to_multiple(sub, data_size(mesh))
    targets_p, _ = pad_batch_to_multiple(targets, data_size(mesh))
    return idx, sub_p, targets_p, n_real


def run_whitebox_sharded(pipeline, inputs, target_img, config, which_adv, mesh: DeviceMesh):
    """Runner-level data-parallel white-box attack: the semantics of
    ``attacks.whitebox.run_whitebox`` (`attack_main2.py:465-498`), each rank
    running the per-image attack (``make_per_image_whitebox``: on the card
    the captured step, replayed) on its rows, the rows gathered at the end.
    Returns ``(adv_inputs, loss_trace)``, the trace (n_selected, iters) of
    per-image totals, pad rows sliced off (the ``per_image_iter`` log
    kind)."""
    from tpufusion_torch.attacks.whitebox import make_per_image_whitebox

    idx, sub_p, targets_p, n_real = prepare_whitebox_batch(inputs, target_img, which_adv, mesh)
    attack = make_per_image_whitebox(pipeline, dataclasses.replace(config, snapshot_every=None))
    adv_local, trace = attack(local_rows(mesh, sub_p), local_rows(mesh, targets_p))
    adv_sel = gather_rows(mesh, adv_local)[:n_real]
    trace = gather_rows(mesh, trace["total"])[:n_real]
    adv = inputs.clone()
    adv[idx] = adv_sel.to(adv.dtype)
    return adv, trace


# ---------------------------------------------------------------------------
# patch training
# ---------------------------------------------------------------------------


def make_sharded_patch_train_step(pipeline, config, mesh: DeviceMesh):
    """Batch-synchronous data-parallel adversarial-patch training step (the
    JAX package's generalisation of the reference's sequential loop,
    `adversarial_patch.py:94-160`): every image of the batch gets its own
    random placement of the one shared patch, the loss is the row-weighted
    mean of the per-image encoder drift, and the PATCH gradient,
    differentiated through the placement, is summed over the ranks.

    Semantics per step (`:111-158`): ``max_count`` iterations on fixed
    placements, ``patch -= step_size * grad``, clamp to the batch's pixel
    range (`:138`).

    Returns ``(step, place_batch)``. ``place_batch(imgs, patch,
    row_weights=None)`` takes this rank's rows of the padded batch (and of
    the weights); ``step(imgs, patch, generator, row_weights=None, *,
    draws=None) -> (patch', loss_trace)`` on them. Image i of the padded
    batch draws its placement from the i-th generator split from
    ``generator`` (every rank splits them all, so a draw does not depend on
    the rank), or takes ``draws[i]`` (the transforms' ``draw=``) when
    given. ``row_weights`` masks rows out of the shared-patch gradient:
    padded rows MUST weigh 0, or they count twice in the weighted mean."""
    from tpufusion_torch.attacks.patch import circle_transform, draw_placement, square_transform
    from tpufusion_torch.core.imaging import avg_pool

    cfg = config
    factor = pipeline.pool_factor
    size = pipeline.image_size
    transform = square_transform if cfg.patch_type == "square" else circle_transform

    def step(imgs, patch, generator=None, row_weights=None, *, draws=None):
        n = imgs.shape[0] * data_size(mesh)
        if draws is None:
            side = patch.shape[0]
            draws = [draw_placement(cfg.patch_type, split_generator(generator), size, side)
                     for _ in range(n)]
        mine = draws[data_rows(mesh, n)]
        if row_weights is None:
            row_weights = torch.ones(imgs.shape[0], device=imgs.device)
        with torch.no_grad():
            latent_org = pipeline.encoder(avg_pool(imgs, factor))
            # the batch's pixel range and the global weight sum
            lims = all_reduce_data(mesh, torch.stack([-imgs.min(), imgs.max()]).float(),
                                   dist.ReduceOp.MAX)
            cmin, cmax = -lims[0], lims[1]
            wsum = all_reduce_data(mesh, row_weights.float().sum())
            masks = torch.stack([transform(patch, size, draw=d)[1] for d in mine])
        trace = []
        for _ in range(cfg.max_count):
            p = patch.detach().requires_grad_(True)
            canvases = torch.stack([transform(p, size, draw=d)[0] for d in mine])
            adv = (1.0 - masks) * imgs + masks * canvases
            adv_latent = pipeline.encoder(avg_pool(adv, factor))
            d = latent_org.float() - adv_latent.float()
            per = (d * d).flatten(1).mean(dim=1)
            # this rank's share of the weighted mean; the ranks' shares and
            # their patch gradients are summed in one all-reduce
            loss = cfg.w_latent_org * (row_weights * per).sum() / wsum
            (g,) = torch.autograd.grad(loss, p)
            both = all_reduce_data(mesh, torch.cat([g.flatten(), loss.detach().reshape(1)]))
            with torch.no_grad():
                patch = torch.minimum(torch.maximum(
                    patch - cfg.step_size * both[:-1].view_as(patch), cmin), cmax)
            trace.append(both[-1])
        return patch, torch.stack(trace)

    def place_batch(imgs, patch, row_weights=None):
        placed = (local_rows(mesh, imgs), patch)
        if row_weights is None:
            return placed
        return placed + (local_rows(mesh, row_weights),)

    return step, place_batch


def train_patch_sharded(pipeline, images, generator, config, mesh: DeviceMesh,
                        target_img=None, log_fn=None, *, init_patch=None, draws=None):
    """Data-parallel patch training: per epoch the whole train set forms ONE
    batch over ``data`` and the patch update is the gradient summed over
    every placement (batch-synchronous, where the reference's loop is
    sequential per image, `adversarial_patch.py:94-160`). Returns the same
    ``(canvas, mask)`` pair as ``attacks.patch.train_patch``.

    The initial patch draws from a generator split from ``generator``, then
    each epoch's placements from one more split, unless ``init_patch`` and
    ``draws`` (per epoch, one draw per image of the padded batch) are given.
    ``target_img`` is accepted for signature parity with ``train_patch``;
    the loss is the encoder-drift objective (`adversarial_patch.py:126`),
    which does not use it. ``log_fn(epoch, 0, trace)`` gets each epoch's
    loss trace as numpy."""
    from tpufusion_torch.attacks.patch import canonical_canvas, init_patch_circle, init_patch_square

    cfg = config
    if init_patch is None:
        init = init_patch_square if cfg.patch_type == "square" else init_patch_circle
        init_patch = init(pipeline.image_size, cfg.patch_frac, split_generator(generator))
    patch = init_patch
    imgs = torch.cat([torch.as_tensor(im) for im in images], dim=0)
    imgs, n_real = pad_batch_to_multiple(imgs, data_size(mesh))
    # wrapped pad rows weigh 0 in the shared-patch gradient: otherwise the
    # duplicated images count twice in the weighted mean
    row_weights = (torch.arange(imgs.shape[0], device=imgs.device) < n_real).float()
    step, place_batch = make_sharded_patch_train_step(pipeline, cfg, mesh)
    for epoch in range(cfg.epochs):
        epoch_draws = None if draws is None else draws[epoch]
        gen = split_generator(generator) if epoch_draws is None else None
        s_imgs, s_patch, s_w = place_batch(imgs, patch, row_weights)
        patch, trace = step(s_imgs, s_patch, gen, s_w, draws=epoch_draws)
        if log_fn is not None:
            log_fn(epoch, 0, trace.float().cpu().numpy())
    return canonical_canvas(patch, pipeline.image_size, cfg.patch_type)


# ---------------------------------------------------------------------------
# PGD / FGSM and CW
# ---------------------------------------------------------------------------


def _place_loss_args(args, args_spec, mesh: DeviceMesh):
    """Per-image (``'batch'``) args padded to the ``data`` axis and cut to
    this rank's rows; everything else (``'rep'``) whole, as every rank
    holds it."""
    placed = []
    for a, spec in zip(args, args_spec):
        if spec == "batch":
            a, _ = pad_batch_to_multiple(a, data_size(mesh))
            a = local_rows(mesh, a)
        placed.append(a)
    return tuple(placed)


def run_pgd_sharded(loss_fn, config, inputs, generator, args, args_spec, mesh: DeviceMesh, *,
                    start=None):
    """Data-parallel PGD/FGSM (the runner's ``pgd``/``fgsm``/
    ``pgd_classifier`` branches).

    PGD is batch-parallel (sign(grad) of a mean or sum loss is per image),
    so each rank runs ``attacks.pgd.make_pgd`` on its rows. The random start
    is drawn once at the UNPADDED shape from ``generator`` (every rank's is
    seeded alike), as ``make_pgd`` draws it, then padded by wrapping and
    sliced, so the real rows follow the single-device trajectories.

    Args:
      loss_fn: ``loss_fn(adv, *args) -> scalar``.
      args/args_spec: the loss args and a parallel tuple of ``'batch'``
        (per-image: pad + slice) or ``'rep'`` (whole on every rank).
      start: the start itself, in place of the generator's draw (as
        ``make_pgd(external_start=True)`` takes it; the parity tests pass
        the JAX package's draw).
    Returns ``(adv[:n], trace)``; the (steps,) trace is the mean over the
    ``data`` ranks of each rank's loss, the padded batch's loss for a mean
    loss (wrapped pad rows included: log only)."""
    from tpufusion_torch.attacks.pgd import make_pgd, pgd_random_start

    d = data_size(mesh)
    if start is None:
        start = pgd_random_start(inputs, generator, config)
    inputs_p, n_real = pad_batch_to_multiple(inputs, d)
    start_p, _ = pad_batch_to_multiple(start, d)
    placed = _place_loss_args(args, args_spec, mesh)
    attack = make_pgd(loss_fn, config, external_start=True)
    adv, trace = attack(local_rows(mesh, inputs_p), local_rows(mesh, start_p), *placed)
    return gather_rows(mesh, adv)[:n_real], all_reduce_data(mesh, trace) / d


def run_cw_sharded(logits_fn, config, inputs, labels, args, args_spec, mesh: DeviceMesh):
    """Data-parallel Carlini-Wagner (the runner's ``cw`` branch). The CW
    cost is a SUM over the batch and Adam's moments are elementwise
    (``attacks/cw.py``), so per-image trajectories do not depend on the
    batch: padding by wrapping and slicing over ``data`` reproduces the
    single-device result on the real rows. Returns ``(best_adv[:n],
    best_l2[:n])``."""
    from tpufusion_torch.attacks.cw import make_cw

    d = data_size(mesh)
    inputs_p, n_real = pad_batch_to_multiple(inputs, d)
    labels_p, _ = pad_batch_to_multiple(labels, d)
    placed = _place_loss_args(args, args_spec, mesh)
    best_adv, best_l2 = make_cw(logits_fn, config)(
        local_rows(mesh, inputs_p), local_rows(mesh, labels_p), *placed)
    return gather_rows(mesh, best_adv)[:n_real], gather_rows(mesh, best_l2)[:n_real]


# ---------------------------------------------------------------------------
# fusion groups
# ---------------------------------------------------------------------------


def make_sharded_group_fusion_attack(pipeline, config, mesh: DeviceMesh):
    """Fusion-aware PGD over G independent fusion GROUPS, the group axis
    over ``data``. Within one (N, S, S, 3) group the inputs couple through
    the fused image, so the scalable axis is groups (the reference's
    ``max_num_fusion`` loop, `interpolation.py:1265`). Each rank runs the
    single-device ``make_fusion_attack`` on its groups in turn; group g
    draws its random start from the g-th generator split from the caller's
    (every rank splits them all).

    Returns ``attack(groups (G,N,S,S,3), targets (G|1,1,S,S,3), generator)
    -> (adv (G,N,S,S,3), traces (G, steps))``."""
    from tpufusion_torch.attacks.fusion_attack import make_fusion_attack

    single = make_fusion_attack(pipeline, config)

    def attack(groups, targets, generator):
        # non-divisible group counts pad with wrapped real groups; results
        # keep the caller's G
        groups_p, n_real = pad_batch_to_multiple(groups, data_size(mesh))
        if targets.shape[0] not in (1, groups_p.shape[0]):
            targets, _ = pad_batch_to_multiple(targets, data_size(mesh))
        gens = [None if generator is None else split_generator(generator)
                for _ in range(groups_p.shape[0])]
        advs, traces = [], []
        for g in range(*data_rows(mesh, groups_p.shape[0]).indices(groups_p.shape[0])):
            adv, trace = single(groups_p[g], targets[0 if targets.shape[0] == 1 else g],
                                gens[g])
            advs.append(adv.detach())
            traces.append(trace)
        return (gather_rows(mesh, torch.stack(advs))[:n_real],
                gather_rows(mesh, torch.stack(traces))[:n_real])

    return attack


GROUP_EVAL_KEYS = ("noise", "b_sp", "b_ar", "part_sp", "part_ar", "cri_sp", "cri_ar",
                   "vg_sp", "vg_ar", "ss_sp", "ss_ar")


def make_sharded_group_eval(pipeline, mesh: DeviceMesh):
    """The EVALUATION phase (partial fusion in both modes + the metric rows,
    `interpolation.py:1076-1091,1406-1415`) for G fusion groups, the group
    axis over ``data``: each rank evaluates its groups in turn with the
    runner's serial per-batch evaluation.

    Returns ``evaluate(groups (G,N,S,S,3), advs (G,N,S,S,3)) -> dict`` with
    per-group leading axes: ``noise (G,N)``, ``part_sp/part_ar
    (G,N+1,H,W,C)``, ``b_sp/b_ar (G,1,H,W,C)``, ``cri/vg/ss_{sp,ar}
    (G,N+1)``: what ``runner.run_experiment``'s metric loop computes per
    batch, and takes as ``adv_override`` evals."""
    from tpufusion_torch.eval.metrics import fused_image_metrics_with, mse_per_image
    from tpufusion_torch.eval.partial import benign_fusion, partial_adv_fusion

    drawer = pipeline.drawer

    def metrics(benign, fused):
        return fused_image_metrics_with(lambda vgg, x: vgg(x), pipeline.vgg,
                                        pipeline.pool_factor, benign, fused)

    def group_eval(inputs, adv):
        codes_b = pipeline.get_latents(inputs)
        codes_a = pipeline.get_latents(adv)
        b_sp, _, _ = benign_fusion(drawer, codes_b, "spatial")
        b_ar, _, _ = benign_fusion(drawer, codes_b, "arithmetic")
        part_sp = partial_adv_fusion(drawer, codes_b, codes_a, "spatial")
        part_ar = partial_adv_fusion(drawer, codes_b, codes_a, "arithmetic")
        cri_sp, vg_sp, ss_sp = metrics(b_sp, part_sp)
        cri_ar, vg_ar, ss_ar = metrics(b_ar, part_ar)
        return dict(noise=mse_per_image(inputs, adv), b_sp=b_sp, b_ar=b_ar, part_sp=part_sp,
                    part_ar=part_ar, cri_sp=cri_sp, cri_ar=cri_ar, vg_sp=vg_sp, vg_ar=vg_ar,
                    ss_sp=ss_sp, ss_ar=ss_ar)

    @torch.no_grad()
    def evaluate(groups, advs):
        groups_p, n_real = pad_batch_to_multiple(groups, data_size(mesh))
        advs_p, _ = pad_batch_to_multiple(advs, data_size(mesh))
        rows = range(*data_rows(mesh, groups_p.shape[0]).indices(groups_p.shape[0]))
        outs = [group_eval(groups_p[g], advs_p[g]) for g in rows]
        return {k: gather_rows(mesh, torch.stack([o[k].float() for o in outs]))[:n_real]
                for k in GROUP_EVAL_KEYS}

    return evaluate

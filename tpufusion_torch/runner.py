"""Experiment runner — the attack dispatcher + full evaluation loop (port of
``tpufusion/runner.py``).

Rebuilds the reference's top-level scripts (SURVEY §3.1/§3.2):
``main_optimize`` dispatch by attack name (`attack_main2.py:299-404`), the
benign-fusion / attack / partial-fusion / metrics loop
(`attack_main2.py:990-1111`, `interpolation.py:1267-1451`) and the hybrid
splice (`attack_main2.py:1114-1151`).

With a ``mesh`` of more than one device (``parallel.create_mesh``; one
process per device, every rank running this code alike) the optimisation
attacks take their data-parallel forms (``parallel/sharding.py``).
Randomness comes from an explicit
``torch.Generator`` on the pipeline's device, split into one fresh generator
per attack; PyTorch's draws are not JAX's threefry draws, so the random
attacks (PGD starts, ``dp_noise``, the patch draws) and
``generate_inputs`` give other numbers than the JAX runner for the same seed.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpufusion_torch.attacks import (
    PatchConfig,
    PGDConfig,
    WhiteboxConfig,
    apply_patch,
    dp_noise,
    make_pgd,
    out_domain_more,
    out_domain_single,
    paste_patch,
    splice_hybrid,
    train_patch,
)
from tpufusion_torch.attacks.whitebox import (
    PRESET_ATTACK_MAIN,
    PRESET_INTERPOLATION,
    run_whitebox,
)
from tpufusion_torch.configs import AttackRunConfig
from tpufusion_torch.core.prng import split_generator
from tpufusion_torch.core.trace import spanned
from tpufusion_torch.eval import ResultsTable, benign_fusion, fused_image_metrics, partial_adv_fusion
from tpufusion_torch.eval.metrics import mse_per_image
from tpufusion_torch.io import ArtifactStore, new_adv_dir, new_run_folder, save_image, save_montage, write_parameters
from tpufusion_torch.io.artifacts import to_numpy
from tpufusion_torch.pipeline import FusionPipeline


def _device(pipeline: FusionPipeline) -> torch.device:
    return pipeline.generator.device


def _draw_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 31, (1,), generator=generator,
                             device=generator.device).item())


def uses_mesh(mesh) -> bool:
    """A mesh of more than one device: the sharded routes."""
    return mesh is not None and mesh.size() > 1


def shards_generator(mesh) -> bool:
    """A mesh whose ``model`` axis shards the generator: every generator
    forward is then a collective that every rank must run."""
    return mesh is not None and mesh.size(1) > 1


def run_hybrid_from_dirs(pipeline: FusionPipeline, cfg: AttackRunConfig,
                         dataset_savedir: str, attack_dirs, save_root=None):
    """Hybrid attack from EXISTING run dirs (`attack_main2.py:1124-1151`,
    ``--hybrid_adv_from_existing``): load each dir's persisted
    ``adversarial/all_adv_inputs.npz`` (written by either package), splice
    slot-aligned rows, fuse."""
    n = cfg.n_inputs
    device = _device(pipeline)
    batches = []
    for d in attack_dirs:
        path = os.path.join(dataset_savedir, d, "adversarial", "all_adv_inputs.npz")
        batches.append(torch.as_tensor(ArtifactStore.load(path), device=device))
    hybrid, counts = splice_hybrid(batches, n)
    with torch.no_grad():
        latents = pipeline.get_latents(hybrid)
        fused, singles, features = benign_fusion(pipeline.drawer, latents, "spatial")
    if save_root:
        hdir = new_adv_dir(save_root, f"{cfg.dataset_name}_hybrid_attack")
        write_parameters(hdir, {"dataset": cfg.dataset_name,
                                **{f"attacks {i}": d for i, d in enumerate(attack_dirs)}},
                         filename="hybrid_param.txt")
        save_montage(hybrid, os.path.join(hdir, "hybrid_fusion_inputs.jpg"), nrow=n)
        save_image(fused, os.path.join(hdir, "hybrid_fusion.jpg"))
    return dict(inputs=hybrid, fused=fused, singles=singles, counts=counts)


def load_existing_inputs(path: str, n: int, size: int, *, device=None) -> torch.Tensor:
    """``use_existing_data`` (`interpolation.py:1274-1313`): reuse previously
    saved fusion inputs — an ``all_inputs.npz`` artifact or panel crops of a
    saved montage image — as a tensor on ``device``."""
    from tpufusion_torch.core.dtypes import resolve_device
    from tpufusion_torch.data.adv_inputs import load_adv_inputs

    device = resolve_device(device)
    return torch.as_tensor(load_adv_inputs(path, n, size), device=device)


@torch.no_grad()
def generate_inputs(pipeline: FusionPipeline, n_imgs: int, generator: torch.Generator):
    """``generate_images`` (`attack_main2.py:509-518`): sample z per input and
    synthesise — the data-free path (``--use_generate_img``). The z draws
    come from ``generator`` in turn."""
    drawer = pipeline.drawer
    imgs = []
    for _ in range(n_imgs):
        z = torch.randn((1, 512), generator=generator, device=generator.device)
        img, _ = drawer.z_to_image(z.to(drawer.device))
        imgs.append(img.float())
    # clamp to the valid image range: untrained generators can exceed [-1,1],
    # and every attack's projection step assumes in-range sources
    return torch.cat(imgs, dim=0).clamp(-1.0, 1.0)


def classifier_for(pipeline: FusionPipeline, cfg: AttackRunConfig, generator):
    """The transfer-attack surrogate classifier per dataset
    (`interpolation.py:1331-1365`): ffhq/church -> torchvision-resnet18 gender
    model (2-way head), car -> stanford-car ViT-patch16. Returns
    ``(logits_fn, model)`` with ``logits_fn(model, images) -> (B,K)``, on the
    pipeline's device; random weights are seeded by a draw from
    ``generator``.

    Tiny pipelines (size <= 64) get a proportionally tiny ViT so CPU tests
    exercise the same path."""
    device = _device(pipeline)
    if pipeline.dataset == "car":
        from tpufusion_torch.models.classifiers import create_vit_classifier

        if cfg.paths.car_vit_dir:
            return create_vit_classifier(
                196, pretrained_dir=cfg.paths.car_vit_dir,
                backend=cfg.paths.car_vit_backend, device=device)
        if pipeline.image_size <= 64:
            return create_vit_classifier(
                8, image_size=32, patch_size=8, hidden_size=32,
                num_layers=2, num_heads=2, intermediate_size=64, device=device,
            )
        return create_vit_classifier(196, device=device)
    from tpufusion_torch.models.classifiers import load_gender_classifier

    return load_gender_classifier(cfg.paths.gender_classifier_ckpt, policy=pipeline.policy,
                                  device=device, seed=_draw_seed(generator))


def write_loss_log(run_dir: Optional[str], attack: str, trace,
                   kind: str = "per_iter") -> None:
    """Persist loss traces to ``loss_{attack}.txt`` — the reference's
    inversion-loss logs (`interpolation.py:825-838`,
    `patch/adversarial_patch.py:141-156`), written after the loop.

    ``kind`` labels the rows truthfully:
    - ``per_iter``: 1D batch-mean loss per optimisation step;
    - ``per_image_iter``: 2D (B, iters) — one trajectory per image;
    - ``per_image``: 1D one final value per image (e.g. CW best L2).
    """
    if run_dir is None or trace is None:
        return
    arr = trace.get("total") if isinstance(trace, dict) else trace
    arr = to_numpy(arr)
    lines = []
    if kind == "per_image":
        for b, v in enumerate(arr.reshape(-1)):
            lines.append(f"{b}th img loss:{float(v):.5f}")
    elif kind == "per_image_iter":
        arr = arr.reshape(arr.shape[0], -1)
        for b in range(arr.shape[0]):
            for i in range(arr.shape[1]):
                lines.append(f"{b}th img iter: {i} "
                             f"inversion_loss:{float(arr[b, i]):.5f}")
    else:  # per_iter: batch-mean per step
        for i, v in enumerate(arr.reshape(-1)):
            lines.append(f"iter: {i} inversion_loss:{float(v):.5f}")
    with open(os.path.join(run_dir, f"loss_{attack}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def resolve_whitebox_execution(execution: str, snapshots_active: bool) -> str:
    """Resolve an ``AttackRunConfig.whitebox_execution`` value to a
    ``WhiteboxConfig.execution``: ``"auto"`` picks stepwise when snapshots
    are active and scan otherwise; an explicit ``"scan"``/``"stepwise"`` is
    honoured. Both replay the captured white-box step; ``"stepwise"`` moves
    each snapshot frame to the host as it comes, ``"scan"`` reads nothing on
    the host until the loop ends (``attacks/whitebox.py``)."""
    if execution == "auto":
        return "stepwise" if snapshots_active else "scan"
    if execution not in ("scan", "stepwise"):
        raise ValueError(
            f"whitebox_execution must be 'auto', 'scan' or 'stepwise', "
            f"got {execution!r}")
    return execution


@spanned("runner.dispatch")
def dispatch_attack(
    pipeline: FusionPipeline,
    attack: str,
    inputs: torch.Tensor,
    target_img: torch.Tensor,
    cfg: AttackRunConfig,
    generator: torch.Generator,
    train_images=None,
    run_dir: Optional[str] = None,
    mesh=None,
) -> List[torch.Tensor]:
    """``main_optimize`` equivalent: returns a LIST of adversarial batches
    (out_domain_single yields one batch per substituted index,
    `attack_main2.py:390-395`). ``generator`` (on the pipeline's device)
    draws whatever the attack draws; every rank's is seeded alike.

    With a multi-device ``mesh`` (``--mesh`` on the CLI), every optimisation
    attack routes through its data-parallel form: ``white_box_*`` via
    ``run_whitebox_sharded``, ``patch_white_box`` training via
    ``train_patch_sharded``, ``pgd``/``fgsm``/``pgd_classifier`` via
    ``run_pgd_sharded`` and ``cw``/``cw_classifier`` via ``run_cw_sharded``;
    each is held to its single-device form in
    ``tests/test_torch_parallel.py``. While a profiler session records, the
    call is the host span ``runner.dispatch`` (``core/trace.py``)."""
    size = pipeline.image_size
    use_mesh = uses_mesh(mesh)
    device = _device(pipeline)

    if attack == "dp_noise":
        return [dp_noise(inputs, generator, cfg.scale)]

    if attack == "blur":
        # Gaussian-blur robustness baseline (`add_noise`, attack_main2.py:273-282;
        # demo invocation :214-218 with a large kernel)
        from tpufusion_torch.attacks.baselines import gaussian_blur_noise

        k = max(int(cfg.scale * pipeline.image_size) | 1, 3)  # odd kernel
        return [gaussian_blur_noise(inputs, k)]

    if attack == "patch":
        return [paste_patch(inputs, target_img, cfg.paste_times)]

    if attack == "out_domain_more":
        return [out_domain_more(inputs, target_img)]

    if attack == "out_domain_single":
        return [
            out_domain_single(inputs, target_img, i) for i in range(inputs.shape[0])
        ]

    if attack == "patch_white_box":
        if not cfg.regenerate or cfg.patch_npz:
            # reuse a previously trained patch (`--regenerate 0` semantics,
            # `adversarial_patch.py:211-213`)
            if not cfg.patch_npz:
                raise ValueError(
                    "regenerate=False requires patch_npz pointing at a "
                    "previously saved patch.npz (patch+mask)")
            with np.load(cfg.patch_npz) as data:
                canvas = torch.as_tensor(data["patch"], device=device)
                mask = torch.as_tensor(data["mask"], device=device)
        else:
            pcfg = PatchConfig(
                patch_type=cfg.patch_type, patch_frac=cfg.patch_size,
                max_count=cfg.max_count, epochs=cfg.epochs,
            )
            imgs = train_images if train_images is not None else [
                inputs[i : i + 1] for i in range(inputs.shape[0])
            ]
            # the traces arrive as numpy; skip them without a run_dir (the
            # log would be discarded)
            plog: list = []
            _plog = None
            if run_dir:
                def _plog(epoch, i, trace):
                    plog.append((epoch, i, trace))

            if use_mesh:
                from tpufusion_torch.parallel import train_patch_sharded

                canvas, mask = train_patch_sharded(pipeline, imgs, generator, pcfg, mesh,
                                                   target_img, log_fn=_plog)
            else:
                canvas, mask = train_patch(pipeline, imgs, generator, pcfg,
                                           target_img, log_fn=_plog)
            if run_dir and plog:
                plog = [
                    f"epoch {e} img {i} count {c} loss:{float(v):.5f}"
                    for e, i, tr in plog
                    for c, v in enumerate(np.asarray(tr).ravel())
                ]
                # patch training loss log (`adversarial_patch.py:141-156`)
                with open(os.path.join(run_dir, "loss_patch_white_box.txt"),
                          "w") as f:
                    f.write("\n".join(plog) + "\n")
        if run_dir:
            np.savez(os.path.join(run_dir, "patch.npz"),
                     patch=to_numpy(canvas), mask=to_numpy(mask))
        return [apply_patch(inputs, canvas, mask)]

    if attack in ("white_box_target", "white_box_patch"):
        # mid-run snapshots only when there's somewhere to write them
        # (reference `args.save_img` gate, `attack_main2.py:657`); the
        # sharded route takes none
        snap_every = (cfg.snapshot_every if run_dir and cfg.snapshot_every and not use_mesh
                      else None)
        accum = max(int(cfg.whitebox_grad_accum or 1), 1)
        # both executors walk the grad_accum chunks; execution decides only
        # where the snapshot frames go
        execution = resolve_whitebox_execution(
            cfg.whitebox_execution, bool(snap_every))
        wcfg = WhiteboxConfig(
            lr=cfg.lr, n_iters=cfg.iters_for(size),
            weights=(PRESET_INTERPOLATION
                     if cfg.whitebox_preset == "interpolation"
                     else PRESET_ATTACK_MAIN),
            snapshot_every=snap_every,
            grad_accum=accum,
            execution=execution,
        )
        if attack == "white_box_patch":
            # per-image paste target (`attack_main2.py:339-351`)
            target = paste_patch(inputs, target_img, cfg.paste_times)
        else:
            target = target_img
        if use_mesh:
            if accum > 1:
                raise ValueError(
                    "whitebox_grad_accum > 1 is a single-chip activation "
                    "lever; with --mesh the DP sharding already splits the "
                    "batch across devices — drop one of the two")
            from tpufusion_torch.parallel import run_whitebox_sharded

            adv, tr = run_whitebox_sharded(pipeline, inputs, target, wcfg, cfg.which_adv, mesh)
        elif snap_every:
            adv, tr, snaps = run_whitebox(pipeline, inputs, target, wcfg,
                                          cfg.which_adv)
            # reference names: adv_input_<name>_<iter>.png / rec_...
            # (`attack_main2.py:660-661`); one montage per snapshot here
            n_rows = int(snaps["adv_input"].shape[1])
            for k in range(int(snaps["adv_input"].shape[0])):
                it = (k + 1) * snap_every
                save_montage(snaps["adv_input"][k], os.path.join(
                    run_dir, f"adv_input_{attack}_{it}.png"), nrow=n_rows)
                save_montage(snaps["rec"][k], os.path.join(
                    run_dir, f"rec_{attack}_{it}.png"), nrow=n_rows)
        else:
            adv, tr = run_whitebox(pipeline, inputs, target, wcfg, cfg.which_adv)
        write_loss_log(run_dir, attack, tr, kind="per_image_iter")
        return [adv]

    if attack in ("pgd", "fgsm"):
        # encoder-drift objective: push codes away from the originals,
        # computed without a graph
        from tpufusion_torch.core.imaging import avg_pool

        with torch.no_grad():
            latent_org = pipeline.encode(inputs)
        factor = pipeline.pool_factor

        def loss(adv, ref_codes):
            codes = pipeline.encoder(avg_pool(adv, factor))
            return ((codes.float() - ref_codes.float()) ** 2).mean()

        eps = cfg.pgd_eps * 2.0  # [-1,1] range is 2x the [0,1] recipe
        if attack == "fgsm":
            # R+FGSM (Tramèr et al. 2018): one full-eps signed step from a
            # random point.  Plain FGSM is DEGENERATE on this objective:
            # codes == ref_codes at the clean start, so the squared-error
            # gradient is exactly zero and the step direction would be pure
            # rounding noise.  The random start breaks the tie with a real
            # first-order direction.
            pcfg = PGDConfig(eps=eps, alpha=eps, steps=1, random_start=True)
        else:
            pcfg = PGDConfig(eps=eps, alpha=cfg.pgd_alpha * 2.0,
                             steps=cfg.pgd_steps, random_start=True)
        if use_mesh:
            from tpufusion_torch.parallel import run_pgd_sharded

            adv, tr = run_pgd_sharded(loss, pcfg, inputs, generator, (latent_org,), ("batch",),
                                      mesh)
        else:
            adv, tr = make_pgd(loss, pcfg, fixed=(pipeline,))(inputs, generator, latent_org)
        write_loss_log(run_dir, attack, tr)
        return [adv]

    if attack in ("fusion_pgd_arith", "fusion_pgd_spatial"):
        # fusion-aware PGD (BASELINE configs 2-3): differentiate through the
        # FULL pipeline and pull the fused output toward the target image
        from tpufusion_torch.attacks.fusion_attack import FusionAttackConfig, make_fusion_attack

        mode = "arithmetic" if attack.endswith("arith") else "spatial"
        facfg = FusionAttackConfig(
            mode=mode, objective="pixel", targeted=True,
            pgd=PGDConfig(eps=cfg.pgd_eps * 2.0, alpha=cfg.pgd_alpha * 2.0,
                          steps=cfg.pgd_steps),
        )
        adv, tr = make_fusion_attack(pipeline, facfg)(inputs, target_img, generator)
        write_loss_log(run_dir, attack, tr)
        return [adv]

    if attack == "pgd_classifier":
        # the reference classifier-transfer PGD recipe (`interpolation.py:
        # 1343`): PGD(model, eps=8/255, alpha=0.01, steps=100, random_start)
        # ascending the CE of the surrogate classifier's clean-prediction
        # labels; the resize to the classifier input happens INSIDE the
        # differentiated function, so the perturbation lives at full fusion
        # resolution.
        logits_fn, model = classifier_for(pipeline, cfg, generator)
        with torch.no_grad():
            labels = logits_fn(model, inputs).argmax(dim=-1)

        def ce_loss(adv, model_, labels_):
            return F.cross_entropy(logits_fn(model_, adv).float(), labels_)

        pcfg = PGDConfig(eps=cfg.pgd_eps * 2.0, alpha=cfg.pgd_alpha * 2.0,
                         steps=cfg.pgd_steps, random_start=True)
        if use_mesh:
            from tpufusion_torch.parallel import run_pgd_sharded

            adv, tr = run_pgd_sharded(ce_loss, pcfg, inputs, generator, (model, labels),
                                      ("rep", "batch"), mesh)
        else:
            adv, tr = make_pgd(ce_loss, pcfg)(inputs, generator, model, labels)
        write_loss_log(run_dir, attack, tr)
        if run_dir:
            # persist the transfer crops exactly how the reference reloads
            # them (`interpolation.py:1379-1394`): a padded montage image
            save_montage(adv, os.path.join(
                run_dir, f"{cfg.dataset_name}_adv_images.jpg"), nrow=inputs.shape[0])
        return [adv]

    if attack in ("cw", "cw_classifier"):
        # classifier-based CW (`interpolation.py:1357`, car recipe): tanh-space
        # Adam on the surrogate classifier's logits
        from tpufusion_torch.attacks.cw import CWConfig, make_cw

        logits_fn, model = classifier_for(pipeline, cfg, generator)
        with torch.no_grad():
            labels = logits_fn(model, inputs).argmax(dim=-1)
        cwcfg = CWConfig(steps=cfg.cw_steps, lr=0.01)  # c = ref 1e-4 default
        if use_mesh:
            from tpufusion_torch.parallel import run_cw_sharded

            adv, best_l2 = run_cw_sharded(lambda x, m: logits_fn(m, x), cwcfg, inputs, labels,
                                          (model,), ("rep",), mesh)
        else:
            adv, best_l2 = make_cw(lambda x, m: logits_fn(m, x), cwcfg)(inputs, labels, model)
        write_loss_log(run_dir, attack, best_l2, kind="per_image")
        if run_dir:
            save_montage(adv, os.path.join(
                run_dir, f"{cfg.dataset_name}_adv_images.jpg"), nrow=inputs.shape[0])
        return [adv]

    if attack == "adv_generate":
        # load pre-generated adversarial inputs (`interpolation.py:1377-1394`)
        from tpufusion_torch.data.adv_inputs import load_adv_inputs

        src = cfg.paths.adv_inputs_path
        if not src:
            raise ValueError(
                "adv_generate needs paths.adv_inputs_path (an "
                "all_adv_inputs.npz artifact or a montage image)"
            )
        adv = load_adv_inputs(src, inputs.shape[0], size)
        return [torch.as_tensor(adv, device=device)]

    raise ValueError(f"unknown attack {attack!r}")


def run_experiment(
    pipeline: FusionPipeline,
    cfg: AttackRunConfig,
    inputs: torch.Tensor,
    target_img: torch.Tensor,
    generator: torch.Generator,
    save_root: Optional[str] = None,
    discriminator=None,
    mesh=None,
    adv_override: Optional[dict] = None,
) -> dict:
    """One full attack evaluation on one fusion batch: benign fusion (both
    modes), attack, partial fusion (both modes), metric table, artifacts.

    ``generator`` (on the pipeline's device) is split into one generator per
    attack. ``discriminator`` is a ``models.discriminator.Discriminator`` on
    the pipeline's device, or None. ``adv_override`` maps an attack name to
    ``{"batches": [adv, ...], "trace": loss_trace|None, "evals": [eval_dict
    |None, ...]}`` — precomputed adversarial inputs that replace that
    attack's dispatch; an ``evals`` entry carries that batch's
    ``noise/part_sp/part_ar/cri_*/vg_*/ss_*`` and replaces the per-batch
    partial-fusion + metric computation below (the group-parallel
    evaluation, ``parallel.make_sharded_group_eval``). ``mesh`` routes the
    heavy attacks through their sharded forms (see ``dispatch_attack``).

    Returns a dict of results (and writes images/artifacts when
    ``save_root``).
    """
    results: dict = {}
    n = inputs.shape[0]
    device = _device(pipeline)
    with torch.no_grad():
        all_latents = pipeline.get_latents(inputs)
        b_sp, singles_sp, feats = benign_fusion(pipeline.drawer, all_latents, "spatial")
        b_ar, singles_ar, _ = benign_fusion(pipeline.drawer, all_latents, "arithmetic")

    # optional realism scoring (C22): the reference loads a stylegan2-ada D
    # and (in commented blocks, `attack_main2.py:1029-1032,1091-1094`) prints
    # D logits of inputs / fused images; the scorer runs eagerly
    def _realism(imgs):
        if discriminator is None:
            return None
        from tpufusion_torch.models.discriminator import realism_scores

        with torch.no_grad():
            return realism_scores(discriminator, imgs)

    results["realism"] = dict(
        inputs=_realism(inputs), fused_spatial=_realism(b_sp),
    ) if discriminator is not None else None
    # spatial singles come back in the reference's reconstruction order —
    # pair each input with ITS OWN reconstruction for the rec loss
    from tpufusion_torch.fusion.spatial import recon_index

    order = torch.as_tensor(recon_index(pipeline.dataset), device=inputs.device)
    rec_loss = mse_per_image(inputs[order], singles_sp)
    results["benign"] = dict(
        fused_spatial=b_sp, fused_arith=b_ar, rec_loss=rec_loss, features=feats
    )

    for attack in cfg.attacks:
        run_dir = None
        store = None
        if save_root:
            run_dir = new_adv_dir(save_root, cfg.run_postfix(attack, pipeline.image_size))
            benign_dir = new_run_folder(os.path.join(run_dir, "benign"))
            adv_dir = new_run_folder(os.path.join(run_dir, "adversarial"))
            run_params = {
                "adversarial attack": attack, "dataset": cfg.dataset_name,
                "dataset size": pipeline.image_size, "epochs": cfg.epochs,
                "max_count": cfg.max_count, "patch_size": cfg.patch_size,
                "train_size": cfg.train_size, "patch_type": cfg.patch_type,
                "white-box max_iter": cfg.iters_for(pipeline.image_size),
                "white-box lr": cfg.lr, "use_generate_img": cfg.use_generate_img,
            }
            if cfg.whitebox_grad_accum > 1 and attack in (
                    "white_box_target", "white_box_patch"):
                # execution detail (results equal the unchunked run), but
                # worth recording: the run's activation footprint was
                # batch/accum per step
                run_params["whitebox grad_accum"] = cfg.whitebox_grad_accum
            if attack == "fgsm":
                # 'fgsm' dispatches as R+FGSM (see dispatch_attack: plain
                # FGSM is gradient-degenerate on the drift objective), so
                # results are PRNG-dependent — record the real semantics so
                # downstream comparisons aren't mislabeled as standard FGSM.
                run_params["attack semantics"] = "r+fgsm (random_start, steps=1)"
            write_parameters(run_dir, run_params)
            save_montage(inputs, os.path.join(benign_dir, "spatial_org_inputs_0.jpg"), nrow=n)
            save_image(b_sp, os.path.join(benign_dir, "spatial_org_fusion_0.jpg"))
            save_montage(singles_sp, os.path.join(benign_dir, "spatial_org_without_fusion_0.jpg"), nrow=n)
            save_image(b_ar, os.path.join(benign_dir, "arith_org_fusion_0.jpg"))
            save_montage(singles_ar, os.path.join(benign_dir, "arith_org_without_fusion_0.jpg"), nrow=n)
            store = ArtifactStore(adv_dir)
            store.append("all_inputs", inputs)
            store.append("all_rec_loss", rec_loss)
            store.append("all_inner_feature", feats)

        k = split_generator(generator)
        pre_evals = None
        if adv_override and attack in adv_override:
            adv_batches = [torch.as_tensor(b, device=device)
                           for b in adv_override[attack]["batches"]]
            write_loss_log(run_dir, attack, adv_override[attack].get("trace"))
            pre_evals = adv_override[attack].get("evals")
        else:
            adv_batches = dispatch_attack(
                pipeline, attack, inputs, target_img, cfg, k, run_dir=run_dir,
                mesh=mesh,
            )

        table = ResultsTable(n)
        attack_results = []
        for bi, adv in enumerate(adv_batches):
            adv = adv.detach()
            pre = pre_evals[bi] if pre_evals and bi < len(pre_evals) else None
            with torch.no_grad():
                if pre is not None:
                    adv_latents = None  # only needed for artifacts; lazy below
                    part_sp, part_ar = pre["part_sp"], pre["part_ar"]
                    noise = pre["noise"]
                    cri_sp, vg_sp, ss_sp = pre["cri_sp"], pre["vg_sp"], pre["ss_sp"]
                    cri_ar, vg_ar, ss_ar = pre["cri_ar"], pre["vg_ar"], pre["ss_ar"]
                else:
                    adv_latents = pipeline.get_latents(adv)
                    part_sp = partial_adv_fusion(pipeline.drawer, all_latents, adv_latents, "spatial")
                    part_ar = partial_adv_fusion(pipeline.drawer, all_latents, adv_latents, "arithmetic")
                    noise = mse_per_image(inputs, adv)
                    cri_sp, vg_sp, ss_sp = fused_image_metrics(pipeline, b_sp, part_sp)
                    cri_ar, vg_ar, ss_ar = fused_image_metrics(pipeline, b_ar, part_ar)
            table.add_batch(noise, cri_sp, cri_ar, vg_sp, vg_ar, ss_sp, ss_ar)
            attack_results.append(dict(
                adv_inputs=adv, noise=noise,
                adv_realism=_realism(part_sp[-1:]),
                partial_spatial=part_sp, partial_arith=part_ar,
                cri_spatial=cri_sp, cri_arith=cri_ar,
                vg_spatial=vg_sp, vg_arith=vg_ar,
                ssim_spatial=ss_sp, ssim_arith=ss_ar,
            ))
            if store is not None or shards_generator(mesh):
                # with the generator sharded over 'model', every rank runs
                # this forward (a collective); the writing rank stores it
                with torch.no_grad():
                    if adv_latents is None:
                        adv_latents = pipeline.get_latents(adv)
                    adv_singles, _ = pipeline.drawer.w_plus_to_image(adv_latents)
            if store is not None:
                store.append("all_adv_inputs", adv)
                store.append("all_adv_rec_loss", mse_per_image(adv, adv_singles))
                save_montage(adv, os.path.join(store.run_dir, f"adv_inputs_0_{bi}_all.jpg"), nrow=n)
                save_image(part_sp[-1:], os.path.join(store.run_dir, f"spatial_adv_fusion_0_{bi}_all.jpg"))
                save_montage(part_sp, os.path.join(store.run_dir, f"spatial_partial_fusion_0_{bi}_all.jpg"), nrow=n + 1)
                save_montage(part_ar, os.path.join(store.run_dir, f"arith_partial_fusion_0_{bi}_all.jpg"), nrow=n + 1)
                # periodic flush (`attack_main2.py:1096-1100` writes the
                # accumulated npz every 5 batches): a killed run keeps every
                # batch completed before the last flush
                if cfg.flush_every and (bi + 1) % cfg.flush_every == 0:
                    store.flush()

        if store is not None:
            store.flush()
            table.save(os.path.join(run_dir, "new_mask.xlsx"))
            # machine-readable twin of the xlsx: one JSON line per batch
            with open(os.path.join(run_dir, "results.jsonl"), "w") as f:
                for bi, r in enumerate(attack_results):
                    f.write(json.dumps(dict(
                        attack=attack, batch=bi,
                        noise_mse=float(to_numpy(r["noise"]).mean()),
                        cri_spatial=[float(v) for v in to_numpy(r["cri_spatial"])],
                        cri_arith=[float(v) for v in to_numpy(r["cri_arith"])],
                        vg_spatial=[float(v) for v in to_numpy(r["vg_spatial"])],
                        vg_arith=[float(v) for v in to_numpy(r["vg_arith"])],
                        ssim_spatial=[float(v) for v in to_numpy(r["ssim_spatial"])],
                        ssim_arith=[float(v) for v in to_numpy(r["ssim_arith"])],
                    )) + "\n")
        results[attack] = attack_results
        results.setdefault("_run_dirs", {})[attack] = run_dir

    if cfg.hybrid_adv and len(cfg.attacks) >= 1:
        pieces = [results[a][0]["adv_inputs"] for a in cfg.attacks]
        hybrid, counts = splice_hybrid(pieces, n)
        with torch.no_grad():
            h_latents = pipeline.get_latents(hybrid)
            h_sp, h_singles, _ = benign_fusion(pipeline.drawer, h_latents, "spatial")
        results["hybrid"] = dict(inputs=hybrid, fused=h_sp, counts=counts)
        if save_root:
            hdir = new_adv_dir(save_root, f"{cfg.dataset_name}_hybrid_attack")
            save_montage(hybrid, os.path.join(hdir, "hybrid_fusion_inputs.jpg"), nrow=n)
            save_image(h_sp, os.path.join(hdir, "hybrid_fusion.jpg"))

    return results


def run_transfer_chain(
    pipeline: FusionPipeline,
    cfg: AttackRunConfig,
    inputs: torch.Tensor,
    target_img: torch.Tensor,
    generator: torch.Generator,
    save_root: str,
    attack: str = "pgd_classifier",
) -> dict:
    """The reference's classifier-transfer flow as ONE call
    (`interpolation.py:1331-1394`): (1) attack the surrogate classifier and
    persist the adversarial crops (montage + npz), (2) reload them through the
    ``adv_generate`` path and run the full fusion evaluation.

    Returns ``dict(generate=<stage-1 results>, fuse=<stage-2 results>,
    adv_inputs_path=<the persisted npz>)``."""
    import dataclasses as _dc

    gen_cfg = _dc.replace(cfg, attacks=(attack,))
    stage1 = run_experiment(pipeline, gen_cfg, inputs, target_img, generator,
                            save_root=save_root)
    run_dir = stage1["_run_dirs"][attack]
    adv_path = os.path.join(run_dir, "adversarial", "all_adv_inputs.npz")

    fuse_paths = _dc.replace(cfg.paths, adv_inputs_path=adv_path)
    fuse_cfg = _dc.replace(cfg, attacks=("adv_generate",), paths=fuse_paths)
    stage2 = run_experiment(pipeline, fuse_cfg, inputs, target_img,
                            split_generator(generator), save_root=save_root)
    return dict(generate=stage1, fuse=stage2, adv_inputs_path=adv_path)

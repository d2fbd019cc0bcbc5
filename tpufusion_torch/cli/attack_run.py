"""Main attack CLI (port of ``tpufusion/cli/attack_run.py``) — CLI analog
of ``attack_main2.py __main__`` (`:842-1151`) and ``interpolation.py
__main__`` (`:1094-1494`).

Runs end-to-end with NO external checkpoints or datasets: absent a
``--images_dir`` it synthesises the fusion inputs from the generator
(the reference's ``--use_generate_img`` path, `attack_main2.py:1001-1002`)
and absent a ``--target_image`` it synthesises an out-of-domain target from a
fixed seed (standing in for ``vase1.png``, `attack_main2.py:916`).

Flags, preset resolution and messages are the JAX CLI's. It runs on the
card unless ``--device`` says otherwise. ``--mesh data=N[,model=M]`` runs
the sharded routes over one process per device, so it runs under torchrun
and the mesh must cover the whole world (data x model = world size; the
JAX CLI takes the first data x model visible devices instead). With
several fusion groups it attacks and evaluates them group-parallel; only
rank 0 writes run folders and prints.

Examples:
    python -m tpufusion_torch.cli.attack_run --dataset ffhq --size 32 --tiny \\
        --device cpu --attacks dp_noise pgd --save_dir runs
    torchrun --nproc-per-node 4 -m tpufusion_torch.cli.attack_run \\
        --attacks white_box_target fusion_pgd_arith --max_num_fusion 8 --mesh data=4
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tpufusion_torch attack CLI")
    p.add_argument("--config", default=None,
                   help="JSON preset from configs/ (CLI flags that are "
                        "explicitly set override preset values)")
    p.add_argument("--dataset", default="ffhq", choices=["ffhq", "car", "church"])
    p.add_argument("--attacks", nargs="*", default=["dp_noise"],
                   help="attack names (see tpufusion_torch.configs.ATTACK_CHOICES)")
    p.add_argument("--images_dir", default=None)
    p.add_argument("--align", action="store_true",
                   help="FFHQ-align raw images before encoding (default "
                        "provider: the packaged trained LandmarkNet; "
                        "override with --landmark_net or --dlib_predictor)")
    p.add_argument("--landmark_net", default=None,
                   help="trained LandmarkNet weights (.npz) for --align "
                        "(default: the packaged models/weights net)")
    p.add_argument("--dlib_predictor", default=None,
                   help="dlib shape-predictor .dat for --align (if dlib is "
                        "installed)")
    p.add_argument("--target_image", default=None)
    p.add_argument("--save_dir", default="runs")
    p.add_argument("--size", type=int, default=None, help="generator size override")
    p.add_argument("--tiny", action="store_true", help="tiny test-scale models")
    p.add_argument("--seed", type=int, default=123456789)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n_iters", type=int, default=None)
    p.add_argument("--which_adv", type=int, nargs="*", default=[])
    p.add_argument("--whitebox_stepwise", action="store_true",
                   help="alias for --whitebox_execution stepwise")
    p.add_argument("--whitebox_execution", default="auto",
                   choices=["auto", "scan", "stepwise"],
                   help="the JAX CLI's white-box executor name: the port "
                        "runs one Python loop for both, so the value is "
                        "validated and recorded (and 'scan' refuses "
                        "--whitebox_grad_accum > 1, as in JAX)")
    p.add_argument("--whitebox_grad_accum", type=int, default=1,
                   help="sequential microbatch chunks per white-box "
                        "iteration: >1 bounds activation memory to "
                        "batch/accum per step so effective batches beyond "
                        "the single-chip ceiling run without OOM "
                        "(stepwise executor)")
    p.add_argument("--whitebox_preset", default="attack_main",
                   choices=["attack_main", "interpolation"],
                   help="white-box loss preset: attack_main2.py:649 or "
                        "interpolation.py:818")
    p.add_argument("--max_count", type=int, default=50)
    p.add_argument("--epochs", type=int, default=1,
                   help="patch-training epochs over the train set")
    p.add_argument("--patch_type", default="square", choices=["square", "circle"])
    p.add_argument("--patch_size", type=float, default=0.1)
    p.add_argument("--patch_npz", default=None,
                   help="precomputed patch.npz (patch+mask) — reuse instead "
                        "of retraining (the reference's regenerate=0 path, "
                        "adversarial_patch.py:211-213)")
    p.add_argument("--paste_times", type=int, default=3)
    p.add_argument("--scale", type=float, default=0.4)
    p.add_argument("--pgd_steps", type=int, default=100,
                   help="PGD iteration budget (reference recipe: 100, `interpolation.py:1343`)")
    p.add_argument("--train_size", type=int, default=2000)
    p.add_argument("--test_size", type=int, default=1000)
    p.add_argument("--max_num_fusion", type=int, default=1,
                   help="number of independent fusion groups to evaluate "
                        "(interpolation.py:1265 batch loop)")
    p.add_argument("--hybrid_adv", action="store_true")
    p.add_argument("--transfer_chain", action="store_true",
                   help="run the classifier-transfer chain: attack the "
                        "surrogate classifier, persist crops, reload via "
                        "adv_generate, fuse (interpolation.py:1331-1394)")
    p.add_argument("--hybrid_from_dirs", nargs="*", default=None,
                   help="existing attack run dirs (under save_dir/dataset) to "
                        "splice a hybrid batch from (--hybrid_adv_from_existing)")
    p.add_argument("--inputs_path", default=None,
                   help="reuse saved fusion inputs: all_inputs.npz artifact or "
                        "montage image (use_existing_data)")
    p.add_argument("--adv_inputs_path", default=None,
                   help="precomputed adversarial inputs for adv_generate")
    p.add_argument("--stylegan_ckpt", default=None)
    p.add_argument("--e4e_ckpt", default=None)
    p.add_argument("--vgg_ckpt", default=None)
    p.add_argument("--fusion_weights", default=None)
    p.add_argument("--discriminator_ckpt", default=None,
                   help="stylegan2-ada pkl with D for realism scoring "
                        "(attack_main2.py:934-938)")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="run on a device mesh: 'data=N[,model=M]' (or just "
                        "N) over one process per device (torchrun "
                        "--nproc-per-node N*M); data x model must equal the "
                        "world size. Routes the attacks through their "
                        "data-parallel forms, model>1 shards the generator, "
                        "and several fusion groups run as the "
                        "group-parallel attack + evaluation")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs the "
                        "plain PyTorch path, as the tests do). Without a card "
                        "and without --device cpu the CLI fails")
    p.add_argument("--no_save_img", action="store_true")
    p.add_argument("--snapshot_every", type=int, default=5,
                   help="white-box image snapshot cadence in iters "
                        "(0 disables; reference save_img cadence is 5)")
    p.add_argument("--flush_every", type=int, default=5,
                   help="artifact npz flush cadence in batches "
                        "(reference flushes every 5)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="wrap the experiment loop in a torch.profiler trace "
                        "written to DIR/trace.json (chrome://tracing, Perfetto)")
    return p


def _parse_mesh_spec(spec: str) -> dict:
    """'data=4,model=2' | 'data=8' | '8' -> {'data': ..., 'model': ...}."""
    out = {"model": 1}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        if not v:
            k, v = "data", k
        if k not in ("data", "model"):
            raise SystemExit(f"--mesh: unknown axis {k!r} (use data/model)")
        try:
            out[k] = int(v)
        except ValueError:
            raise SystemExit(f"--mesh: bad axis size {v!r} in {spec!r}")
    return out


def mesh_from_spec(spec: dict, device, what: str = "--mesh"):
    """The CLIs' mesh over every process of the group (torchrun's, or one
    rank): data x model must equal the world size, else ``SystemExit``."""
    import torch.distributed as dist

    from tpufusion_torch.parallel import create_mesh
    from tpufusion_torch.parallel.sharding import init_process_group

    init_process_group(device.type)
    world = dist.get_world_size()
    data, model = spec.get("data"), spec["model"]
    want = data * model if data is not None else None
    if (want is not None and want != world) or world % model:
        raise SystemExit(
            f"{what} requests data={data} x model={model} devices but the process "
            f"group has world size {world}: start one process per device "
            f"(torchrun --nproc-per-node {want or model} ...)")
    return create_mesh(device, data=data, model=model)


def _explicit_dests(parser: argparse.ArgumentParser, argv) -> set:
    """Dests of flags literally present on the command line.

    Preset merging must know which flags the user actually typed — comparing
    parsed values against parser defaults mistakes an explicit
    ``--dataset ffhq`` for "unset" (ADVICE r2).  Handles ``--flag=value``
    and argparse's unambiguous prefix abbreviations.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    # Sentinel-default re-parse (ADVICE r3): temporarily swap every action's
    # default for a unique sentinel and let argparse itself decide which
    # dests the command line set — this inherits argparse's exact handling
    # of the '--' separator, prefix abbreviation, and '--flag=value'.
    sentinel = object()
    saved = [(a, a.default) for a in parser._actions]
    try:
        for a, _ in saved:
            a.default = sentinel
        ns, _ = parser.parse_known_args(argv)
    finally:
        for a, d in saved:
            a.default = d
    return {d for d, v in vars(ns).items() if v is not sentinel}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    explicit = _explicit_dests(parser, argv)

    from tpufusion_torch.configs import ATTACK_CHOICES

    unknown = [a for a in (args.attacks or []) if a not in ATTACK_CHOICES]
    if unknown:
        raise SystemExit(
            f"unknown attack(s) {unknown}; choices: {', '.join(ATTACK_CHOICES)}")
    mesh_spec = _parse_mesh_spec(args.mesh) if args.mesh else None

    import torch

    from tpufusion_torch.configs import AttackRunConfig, PathsConfig
    from tpufusion_torch.core.dtypes import resolve_device
    from tpufusion_torch.core.prng import seed_everything
    from tpufusion_torch.data import ImageFolderDataset, setup_loaders, transform_for
    from tpufusion_torch.io import load_image
    from tpufusion_torch.pipeline import FusionPipeline, create_test_pipeline
    from tpufusion_torch.runner import _draw_seed, generate_inputs, run_experiment

    # no card and no --device cpu: fail here, before any work
    device = resolve_device(args.device)
    mesh = None
    if mesh_spec is not None:
        mesh = mesh_from_spec(mesh_spec, device)
    # with a mesh every rank runs the experiment; rank 0 writes and prints
    lead = mesh is None or mesh.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    if args.config:
        from tpufusion_torch.configs import load_config

        cfg = load_config(args.config)
        # CLI flags the user explicitly TYPED override the preset — detected
        # from argv, so a flag explicitly set to its parser default (e.g.
        # ``--dataset ffhq`` against a church preset) still wins
        for cli_key, cfg_key in [
            ("dataset", "dataset_name"), ("lr", "lr"), ("n_iters", "n_iters"),
            ("max_count", "max_count"), ("patch_type", "patch_type"),
            ("patch_size", "patch_size"), ("paste_times", "paste_times"),
            ("scale", "scale"), ("pgd_steps", "pgd_steps"),
            ("train_size", "train_size"), ("test_size", "test_size"),
            ("size", "image_size"), ("epochs", "epochs"),
            ("patch_npz", "patch_npz"), ("max_num_fusion", "max_num_fusion"),
            ("which_adv", "which_adv"), ("seed", "seed"),
            ("whitebox_preset", "whitebox_preset"),
            ("whitebox_grad_accum", "whitebox_grad_accum"),
            ("snapshot_every", "snapshot_every"),
            ("flush_every", "flush_every"),
        ]:
            if cli_key in explicit:
                setattr(cfg, cfg_key, getattr(args, cli_key))
        if "attacks" in explicit:
            cfg.attacks = tuple(args.attacks)
        if args.patch_npz:
            cfg.regenerate = False
        if args.whitebox_stepwise:
            cfg.whitebox_execution = "stepwise"
        elif "whitebox_execution" in explicit:
            cfg.whitebox_execution = args.whitebox_execution
        if args.hybrid_adv:
            cfg.hybrid_adv = True
        if args.align:
            cfg.align = True
        if args.no_save_img:
            cfg.save_img = False
        if args.inputs_path:
            cfg.use_existing_data = True
        for cli_key, path_key in [
            ("images_dir", "images_dir"), ("save_dir", "save_dir"),
            ("stylegan_ckpt", "stylegan_ckpt"), ("e4e_ckpt", "e4e_ckpt"),
            ("vgg_ckpt", "vgg_ckpt"), ("fusion_weights", "fusion_weights"),
            ("target_image", "target_image"),
            ("adv_inputs_path", "adv_inputs_path"),
            ("discriminator_ckpt", "discriminator_ckpt"),
        ]:
            if cli_key in explicit and getattr(args, cli_key) is not None:
                setattr(cfg.paths, path_key, getattr(args, cli_key))
        # reflect resolved preset values back into args — ALL later branches
        # (input loading, target, checkpoints) read args.*, so every field the
        # preset can carry must round-trip here, not just dataset/save_dir
        args.dataset = cfg.dataset_name
        args.save_dir = cfg.paths.save_dir
        args.seed = cfg.seed
        args.whitebox_preset = cfg.whitebox_preset
        if cfg.align:
            args.align = True
        if cfg.image_size is not None:
            args.size = cfg.image_size
        if cfg.paths.images_dir and not args.images_dir:
            args.images_dir = cfg.paths.images_dir
        if cfg.paths.target_image and not args.target_image:
            args.target_image = cfg.paths.target_image
        if cfg.paths.adv_inputs_path and not args.adv_inputs_path:
            args.adv_inputs_path = cfg.paths.adv_inputs_path
        # fields a preset CAN carry but this CLI has no use for — say so
        # instead of silently no-opping
        for fld in ("batch", "n_sample"):
            if getattr(cfg, fld) != getattr(AttackRunConfig(), fld):
                say(f"[attack_run] note: preset field '{fld}' is not used "
                    f"by this CLI (fusion group size comes from the "
                    f"dataset; 'n_sample' drives the invert CLI)")
    else:
        cfg = AttackRunConfig(
            dataset_name=args.dataset, attacks=tuple(args.attacks), lr=args.lr,
            seed=args.seed, align=args.align,
            n_iters=args.n_iters, which_adv=args.which_adv, max_count=args.max_count,
            whitebox_execution=("stepwise" if args.whitebox_stepwise
                                else args.whitebox_execution),
            whitebox_preset=args.whitebox_preset,
            whitebox_grad_accum=args.whitebox_grad_accum,
            epochs=args.epochs, regenerate=args.patch_npz is None,
            patch_npz=args.patch_npz,
            patch_type=args.patch_type, patch_size=args.patch_size,
            paste_times=args.paste_times, scale=args.scale, pgd_steps=args.pgd_steps,
            train_size=args.train_size, test_size=args.test_size,
            max_num_fusion=args.max_num_fusion,
            hybrid_adv=args.hybrid_adv, save_img=not args.no_save_img,
            snapshot_every=args.snapshot_every, flush_every=args.flush_every,
            image_size=args.size,
            hybrid_adv_from_existing=bool(args.hybrid_from_dirs),
            hybrid_adv_dirs=tuple(args.hybrid_from_dirs or ()),
            use_existing_data=bool(args.inputs_path),
            paths=PathsConfig(
                images_dir=args.images_dir, save_dir=args.save_dir,
                stylegan_ckpt=args.stylegan_ckpt, e4e_ckpt=args.e4e_ckpt,
                vgg_ckpt=args.vgg_ckpt, fusion_weights=args.fusion_weights,
                target_image=args.target_image,
                adv_inputs_path=args.adv_inputs_path,
            ),
        )

    if not cfg.attacks:
        # nargs='*' permits `--attacks` with zero names; fail BEFORE the
        # (minutes-long at real scale) pipeline build, not at cfg.attacks[0]
        raise SystemExit("no attacks requested — pass at least one name "
                         f"to --attacks (choices: {', '.join(ATTACK_CHOICES)})")

    # seeding happens AFTER preset resolution so a preset-carried seed is
    # honoured
    args.seed = cfg.seed
    pool = seed_everything(cfg.seed, device)

    if args.transfer_chain and not cfg.save_img:
        raise SystemExit(
            "--transfer_chain persists adversarial crops to disk and reloads "
            "them via adv_generate — it cannot run with --no_save_img / "
            "save_img=false")

    dataset_dir = os.path.join(args.save_dir, args.dataset)
    os.makedirs(dataset_dir, exist_ok=True)

    t0 = time.time()
    say(f"[attack_run] building {args.dataset} pipeline "
        f"(size={args.size or 'default'}, tiny={args.tiny}) on {device} …")
    seed = _draw_seed(pool.next())
    if args.tiny:
        pipeline = create_test_pipeline(args.dataset, size=args.size or 32, device=device,
                                        seed=seed)
    else:
        # model-scale knobs round-trip from the config
        pipeline = FusionPipeline.create(
            args.dataset, size=args.size,
            channel_multiplier=cfg.channel_multiplier,
            encoder_base_channels=cfg.encoder_base_channels,
            encoder_units=tuple(cfg.encoder_units), device=device, seed=seed,
        )
    pipeline = _maybe_load_checkpoints(pipeline, cfg.paths)
    say(f"[attack_run] pipeline ready in {time.time() - t0:.1f}s "
        f"(generator {pipeline.image_size}^2)")
    if mesh is not None:
        if mesh.size(1) > 1:
            from tpufusion_torch.parallel import shard_generator_params

            # TP: shard mapping/affine out-features + conv out-channels
            shard_generator_params(pipeline.generator, mesh, generator=pipeline.generator)
        say(f"[attack_run] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
            f"{mesh.size()} {device.type} device(s)")

    n = cfg.n_inputs

    # hybrid-from-existing: no new attacks, just splice prior runs and fuse
    # (reference clears adversarial_choose in this mode, `attack_main2.py:949-950`)
    if args.hybrid_from_dirs:
        from tpufusion_torch.runner import run_hybrid_from_dirs

        result = run_hybrid_from_dirs(
            pipeline, cfg, dataset_dir, args.hybrid_from_dirs,
            save_root=dataset_dir if lead else None,
        )
        say(f"[attack_run] hybrid splice from {len(args.hybrid_from_dirs)} "
            f"runs (counts {result['counts']}); artifacts under {dataset_dir}")
        return 0

    n_groups = max(cfg.max_num_fusion, 1)
    if args.inputs_path:
        from tpufusion_torch.runner import load_existing_inputs

        inputs = load_existing_inputs(args.inputs_path, n, pipeline.image_size, device=device)
        say(f"[attack_run] reusing saved inputs from {args.inputs_path}")
        input_groups = [inputs]
    elif args.images_dir:
        t_load = time.time()
        preprocess = None
        if args.align:
            from tpufusion_torch.data.alignment import resolve_align_preprocess

            preprocess = resolve_align_preprocess(
                args.landmark_net, args.dlib_predictor, device=device)
        ds = ImageFolderDataset(args.images_dir, transform=transform_for(args.dataset),
                                preprocess=preprocess)
        _, test_loader = setup_loaders(
            ds, train_size=min(cfg.train_size, max(len(ds) - n, 0)),
            test_size=min(cfg.test_size, len(ds)), test_batch_size=n,
            seed=args.seed % (2**31),
        )
        loader_it = iter(test_loader)
        input_groups = []
        for _ in range(n_groups):
            try:
                batch = torch.as_tensor(next(loader_it), device=device)
            except StopIteration:
                break
            if batch.shape[0] < n:
                break
            if batch.shape[1] != pipeline.image_size:
                # dataset transforms emit the reference resolution; shrink
                # when running a reduced-size pipeline (tests / quick runs)
                from tpufusion_torch.core.imaging import resize_bilinear

                batch = resize_bilinear(batch, pipeline.image_size,
                                        pipeline.image_size)
            input_groups.append(batch)
        loader_it.close()  # stop the prefetch thread (and its landmark net)
        if not input_groups:
            raise SystemExit(f"--images_dir yielded no full group of {n} images")
        inputs = input_groups[0]
        say(f"[attack_run] loaded {len(input_groups)} group(s) of {n} images"
            f"{' (aligned)' if args.align else ''} in {time.time() - t_load:.1f}s")
    else:
        say("[attack_run] no --images_dir: generating inputs from the generator")
        # record the data-free path in the run metadata (the reference's
        # --use_generate_img flag, `attack_main2.py:1001-1002`)
        cfg.use_generate_img = True
        input_groups = [generate_inputs(pipeline, n, pool.next())
                        for _ in range(n_groups)]
        inputs = input_groups[0]

    if args.target_image:
        target = torch.as_tensor(load_image(args.target_image, pipeline.image_size),
                                 device=device)
    else:
        # a fixed seed of its own, as the JAX CLI's key 7777 (other draws)
        z = torch.randn((1, 512), generator=torch.Generator().manual_seed(7777)) * 2.0
        with torch.no_grad():
            target, _ = pipeline.drawer.z_to_image(z.to(device))
        target = target.float()

    if args.transfer_chain:
        from tpufusion_torch.runner import run_transfer_chain

        attack = cfg.attacks[0] if cfg.attacks[0] in (
            "pgd_classifier", "cw_classifier", "cw") else "pgd_classifier"
        # the chain reloads its crops from disk: under a mesh the other ranks
        # run it in a folder of their own, removed after
        import shutil
        import tempfile

        chain_root = dataset_dir if lead else tempfile.mkdtemp(prefix="transfer_chain_")
        chain = run_transfer_chain(
            pipeline, cfg, inputs, target, pool.next(), chain_root,
            attack=attack,
        )
        if not lead:
            shutil.rmtree(chain_root, ignore_errors=True)
        r = chain["fuse"]["adv_generate"][0]
        say(f"[attack_run] transfer chain ({attack} -> adv_generate): "
            f"input-noise MSE {float(r['noise'].mean()):.5f}, crops at "
            f"{chain['adv_inputs_path']}")
        return 0

    discriminator = None
    d_ckpt = args.discriminator_ckpt or cfg.paths.discriminator_ckpt
    if d_ckpt:
        from tpufusion_torch.io.ada_pkl import load_network_pkl_tensors
        from tpufusion_torch.models.discriminator import (
            create_discriminator,
            load_ada_discriminator,
        )

        nets = load_network_pkl_tensors(d_ckpt)
        d_tensors = nets.get("D", nets.get("root"))
        if not d_tensors:
            raise SystemExit(
                f"--discriminator_ckpt {d_ckpt} contains no 'D' network "
                f"(found: {sorted(nets)})")
        d = create_discriminator(pipeline.image_size,
                                 channel_multiplier=1 if args.tiny else 2,
                                 policy=pipeline.policy, device=device)
        discriminator = load_ada_discriminator(d_tensors, d)
        say(f"[attack_run] realism scoring with D from {d_ckpt}")

    import contextlib

    profile_ctx = contextlib.nullcontext()
    if args.profile and lead:
        from tpufusion_torch.utils.logging import trace_profile

        profile_ctx = trace_profile(args.profile)
        say(f"[attack_run] profiling to {args.profile}")

    # group-parallel fusion attacks: with a mesh and several groups, attack
    # ALL groups up front with the group axis over 'data' (the reference's
    # max_num_fusion loop, `interpolation.py:1265`), then run the
    # EVALUATION phase (partial fusion both modes + metric rows,
    # `interpolation.py:1076-1091`) for all groups the same way;
    # run_experiment below consumes both via adv_override
    adv_overrides = [dict() for _ in input_groups]
    gp_attacks = [a for a in cfg.attacks if a.startswith("fusion_pgd")]
    if mesh is not None and mesh.size() > 1 and len(input_groups) > 1 and gp_attacks:
        from tpufusion_torch.attacks.fusion_attack import FusionAttackConfig
        from tpufusion_torch.attacks.pgd import PGDConfig
        from tpufusion_torch.parallel import (
            make_sharded_group_eval,
            make_sharded_group_fusion_attack,
        )

        groups_arr = torch.stack(input_groups)
        gp_target = target[None]  # (1, 1, S, S, 3): shared across groups
        gp_eval = make_sharded_group_eval(pipeline, mesh)
        for a in gp_attacks:
            facfg = FusionAttackConfig(
                mode="arithmetic" if a.endswith("arith") else "spatial",
                objective="pixel", targeted=True,
                pgd=PGDConfig(eps=cfg.pgd_eps * 2.0, alpha=cfg.pgd_alpha * 2.0,
                              steps=cfg.pgd_steps),
            )
            gattack = make_sharded_group_fusion_attack(pipeline, facfg, mesh)
            adv_all, traces = gattack(groups_arr, gp_target, pool.next())
            evals = gp_eval(groups_arr, adv_all)
            for gi in range(len(input_groups)):
                per_group = {k: v[gi] for k, v in evals.items()}
                adv_overrides[gi][a] = {"batches": [adv_all[gi]],
                                        "trace": traces[gi],
                                        "evals": [per_group]}
            say(f"[attack_run] {a}: {len(input_groups)} groups attacked AND evaluated "
                f"group-parallel over mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    # one run_experiment per fusion group (`interpolation.py:1265` evaluates
    # max_num_fusion independent batches; each gets its own numbered run dir)
    def run_group(gi: int, group) -> None:
        results = run_experiment(
            pipeline, cfg, group, target, pool.next(),
            save_root=dataset_dir if cfg.save_img and lead else None,
            discriminator=discriminator,
            mesh=mesh, adv_override=adv_overrides[gi] or None,
        )
        tag = f" [group {gi}]" if len(input_groups) > 1 else ""
        if results.get("realism"):
            # the reference prints D logits of benign vs adversarial fused
            # images (`attack_main2.py:1029-1032,1091-1094`, commented-in)
            say(f"[attack_run]{tag} realism(D): benign fused "
                f"{float(results['realism']['fused_spatial'].float().mean()):+.4f}")
        for attack in cfg.attacks:
            for r in results[attack]:
                noise = float(r["noise"].float().mean())
                ssim_all = float(r["ssim_spatial"][-1])
                msg = (f"[attack_run]{tag} {attack}: input-noise MSE "
                       f"{noise:.5f}, spatial SSIM(all-adv vs benign) "
                       f"{ssim_all:.4f}")
                if r.get("adv_realism") is not None:
                    msg += (f", realism(D) adv fused "
                            f"{float(r['adv_realism'].float().mean()):+.4f}")
                say(msg)

    with profile_ctx:
        for gi, group in enumerate(input_groups):
            run_group(gi, group)
    say(f"[attack_run] artifacts under {dataset_dir}")
    return 0


def _maybe_load_checkpoints(pipeline, paths):
    """Fill the reference checkpoints into the pipeline if provided."""
    from tpufusion_torch.io.checkpoint import (
        load_e4e_checkpoint,
        load_stylegan2_checkpoint,
        load_torch_state_dict,
        load_vgg16_checkpoint,
    )

    if paths.stylegan_ckpt:
        state = load_torch_state_dict(paths.stylegan_ckpt)
        load_stylegan2_checkpoint(state.get("g_ema", state), pipeline.generator)
    if paths.e4e_ckpt:
        latent_avg = load_e4e_checkpoint(load_torch_state_dict(paths.e4e_ckpt),
                                         pipeline.encoder)
        if latent_avg is not None:
            pipeline.latent_avg = latent_avg
    if paths.vgg_ckpt:
        load_vgg16_checkpoint(load_torch_state_dict(paths.vgg_ckpt), pipeline.vgg)
    if paths.fusion_weights:
        pipeline.drawer.blender.load_fusion_nets(paths.fusion_weights)
    return pipeline


if __name__ == "__main__":
    sys.exit(main())

"""Export serving artifacts (port of ``tpufusion/cli/export_programs.py``):
the decode and spatial-fusion programs and their weights.

Produces, under ``--out``:
  - ``decode.pt2``            (gen_params, codes) -> image
  - ``fusion.pt2`` (+.roles)  (gen_params, blend_params, mean, base, *swaps) -> fused image
  - ``params.npz``            generator / blender / mean-latent weights (params_io)

A serving process needs only ``tpufusion_torch.io.load_program`` and
``load_pytree`` (no model-building code); ``load_program`` imports
``tpufusion_torch.ops``, which registers the ``tpufusion::styled_conv``
operator the programs call. Export on the device you serve on (``cuda``
unless ``--device`` says otherwise).

Example:
    python -m tpufusion_torch.cli.export_programs --dataset church --tiny --size 32 \\
        --device cpu --out artifacts/
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tpufusion_torch serving-artifact export")
    p.add_argument("--dataset", default="ffhq", choices=["ffhq", "car", "church"])
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--batch", type=int, default=1, help="decode batch size")
    p.add_argument("--out", required=True)
    p.add_argument("--stylegan_ckpt", default=None,
                   help="rosinality g_ema checkpoint to load and ship in "
                        "params.npz (random init otherwise)")
    p.add_argument("--fusion_weights", default=None,
                   help="fusion-net weights JSON manifest")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' for the plain path)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from tpufusion_torch.core.dtypes import resolve_device
    from tpufusion_torch.io.export import export_decode, export_spatial_fusion, module_params
    from tpufusion_torch.io.params_io import save_pytree
    from tpufusion_torch.pipeline import FusionPipeline, create_test_pipeline

    device = resolve_device(args.device)
    if args.tiny:
        pipeline = create_test_pipeline(args.dataset, size=args.size or 32, device=device)
    else:
        pipeline = FusionPipeline.create(args.dataset, size=args.size, device=device)
    if args.stylegan_ckpt or args.fusion_weights:
        # one checkpoint-wiring implementation, shared with attack_run
        from tpufusion_torch.cli.attack_run import _maybe_load_checkpoints
        from tpufusion_torch.configs import PathsConfig

        pipeline = _maybe_load_checkpoints(pipeline, PathsConfig(
            stylegan_ckpt=args.stylegan_ckpt,
            fusion_weights=args.fusion_weights,
        ))

    os.makedirs(args.out, exist_ok=True)
    d = export_decode(pipeline, os.path.join(args.out, "decode.pt2"), batch=args.batch)
    f = export_spatial_fusion(pipeline.drawer, os.path.join(args.out, "fusion.pt2"))
    w = save_pytree(
        dict(gen_params=module_params(pipeline.generator),
             blend_params=module_params(pipeline.drawer.blender),
             mean_latent=pipeline.drawer.mean_latent),
        os.path.join(args.out, "params.npz"),
    )
    for path in (d, f, f + ".roles", w):
        print(f"[export] {path} ({os.path.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

"""Seeded z-fusion demo (port of ``tpufusion/cli/fuse.py``) — CLI analog of
``stylefusion()`` (`attack_main2.py:47-72`): five fixed-seed z codes,
per-part spatial fusion, montage of the five parts + the fused face. Runs on
the card unless ``--device`` says otherwise. The (seed, index) pairs draw
their z from ``torch.Generator``s (``FusionDrawer.seed_to_z``), so the faces
differ from the JAX demo's.

    python -m tpufusion_torch.cli.fuse --dataset ffhq --size 32 --tiny \\
        --device cpu --out fused.jpg
"""

from __future__ import annotations

import argparse
import sys


# the reference demo's (seed, index) pairs (`attack_main2.py:53-57`)
DEMO_SEEDS = dict(
    mouth=(6, 7), background=(23, 8), hair=(334, 6), eyes=(337, 5), global_=(393, 5)
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpufusion_torch z-fusion demo")
    p.add_argument("--dataset", default="ffhq", choices=["ffhq", "car", "church"])
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--out", default="fused_demo.jpg")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    import torch

    from tpufusion_torch.core.dtypes import Policy, resolve_device
    from tpufusion_torch.fusion.drawer import FusionDrawer
    from tpufusion_torch.io import save_montage

    device = resolve_device(args.device)
    drawer = FusionDrawer.create(
        args.dataset, size=args.size,
        channel_multiplier=1 if args.tiny else args.channel_multiplier,
        policy=Policy() if args.tiny else None,
        mean_latent_samples=64 if args.tiny else 4096, device=device,
        generator=torch.Generator(device=device).manual_seed(0),
    )

    z = {k: drawer.seed_to_z(v) for k, v in DEMO_SEEDS.items()}
    parts = []
    with torch.no_grad():
        for name in ("background", "hair", "eyes", "mouth", "global_"):
            img, _ = drawer.generate_img(z[name], latents_type="z")
            parts.append(img)
        if args.dataset == "ffhq":
            fused, _ = drawer.generate_img(
                z["global_"], latents_type="z", hair=z["hair"], eyes=z["eyes"],
                background=z["background"], mouth=z["mouth"],
            )
        elif args.dataset == "car":
            fused, _ = drawer.generate_img(
                z["global_"], latents_type="z", wheels=z["mouth"],
                bg_top=z["background"], bg_bottom=z["hair"],
            )
        else:
            fused, _ = drawer.generate_img(
                z["global_"], latents_type="z", bg_top=z["background"],
                bg_bottom=z["hair"],
            )
    strip = torch.cat(parts + [fused], dim=0)
    out = save_montage(strip, args.out, nrow=strip.shape[0])
    print(f"[fuse] wrote {out} ({strip.shape[0]} panels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

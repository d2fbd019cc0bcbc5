"""Inversion utility (port of ``tpufusion/cli/invert.py``) — CLI analog of
``inversion()`` / ``generate_inversions`` (reference C23,
`attack_main2.py:75-94,173-182`): batch-encode a dataset to latents.npz,
then decode each latent back to an inversion image (cars get the 64:448
centre crop). Runs on the card unless ``--device`` says otherwise.
``--mesh N`` encodes over an N-process ``data`` mesh (torchrun
--nproc-per-node N; N must be the world size): each rank encodes its rows
of every batch and the latents are gathered; rank 0 writes.

    python -m tpufusion_torch.cli.invert --images_dir data/ --dataset ffhq \\
        --tiny --size 32 --device cpu --save_dir runs/inv
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpufusion_torch inversion")
    p.add_argument("--images_dir", required=True)
    p.add_argument("--dataset", default="ffhq", choices=["ffhq", "car", "church"])
    p.add_argument("--save_dir", default="runs/inversion")
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--n_sample", type=int, default=None)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--latents_only", action="store_true")
    p.add_argument("--align", action="store_true",
                   help="FFHQ-align raw images before encoding "
                        "(`attack_main2.py:103-104` loader path)")
    p.add_argument("--landmark_net", default=None)
    p.add_argument("--dlib_predictor", default=None)
    p.add_argument("--mesh", default=None, metavar="N", type=int,
                   help="shard the encode batch over an N-device 'data' "
                        "mesh, one process per device (torchrun "
                        "--nproc-per-node N); batch-encode is embarrassingly "
                        "parallel")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from tpufusion_torch.core.dtypes import resolve_device
    from tpufusion_torch.data import BatchLoader, ImageFolderDataset, transform_for
    from tpufusion_torch.io import save_image
    from tpufusion_torch.pipeline import FusionPipeline, create_test_pipeline

    device = resolve_device(args.device)
    get_latents = None
    lead = True
    if args.mesh and args.mesh > 1:
        from tpufusion_torch.cli.attack_run import mesh_from_spec
        from tpufusion_torch.parallel.sharding import gather_rows, local_rows, pad_batch_to_multiple

        mesh = mesh_from_spec({"data": args.mesh, "model": 1}, device, what=f"--mesh {args.mesh}")
        lead = mesh.get_rank() == 0
        if lead:
            print(f"[invert] DP encode over mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

        def get_latents(batch):
            padded, n_real = pad_batch_to_multiple(batch, args.mesh)
            return gather_rows(mesh, pipeline.get_latents(local_rows(mesh, padded)))[:n_real]
    os.makedirs(args.save_dir, exist_ok=True)
    if args.tiny:
        pipeline = create_test_pipeline(args.dataset, size=args.size or 32, device=device)

        def tf(img):
            img = img.resize((pipeline.image_size, pipeline.image_size))
            return np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0
    else:
        pipeline = FusionPipeline.create(args.dataset, size=args.size, device=device)
        tf = transform_for(args.dataset)

    preprocess = None
    if args.align:
        from tpufusion_torch.data.alignment import resolve_align_preprocess

        preprocess = resolve_align_preprocess(
            args.landmark_net, args.dlib_predictor, device=device)
    ds = ImageFolderDataset(args.images_dir, transform=tf,
                            preprocess=preprocess)
    n = min(args.n_sample or len(ds), len(ds))
    loader = BatchLoader(ds, np.arange(n), args.batch, shuffle=False, drop_last=False)

    get_latents = get_latents or pipeline.get_latents
    all_latents = []
    with torch.no_grad():
        for batch in loader:
            codes = get_latents(torch.as_tensor(batch, device=device))
            all_latents.append(codes.float().cpu().numpy())
    latents = np.concatenate(all_latents, axis=0)
    if not lead:
        return 0
    lat_path = os.path.join(args.save_dir, "latents.npz")
    np.savez(lat_path, latents=latents)
    print(f"[invert] encoded {latents.shape[0]} images -> {lat_path}")

    if not args.latents_only:
        inv_dir = os.path.join(args.save_dir, "inversions")
        os.makedirs(inv_dir, exist_ok=True)
        for i in range(latents.shape[0]):
            with torch.no_grad():
                img = pipeline.decode(torch.as_tensor(latents[i : i + 1], device=device))
            if pipeline.is_cars:
                # cars crop rows 64:448 of 512 (`attack_main2.py:180-181`),
                # scaled to the actual generator size
                s = pipeline.image_size
                img = img[:, s * 64 // 512 : s * 448 // 512]
            save_image(img, os.path.join(inv_dir, f"{i + 1:05d}.jpg"))
        print(f"[invert] wrote {latents.shape[0]} inversions -> {inv_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Image file I/O (port of ``tpufusion/io/images.py``) — the
``vutils.save_image`` / ``tensor2im`` boundary.

All images are NHWC in [-1, 1], tensors (on any device) or arrays; they reach
the host through ``core.imaging._host``. Conversion to uint8 matches the
reference's ``(x+1)/2`` clip (`style_fusion_simple.py:16-22`, saves
everywhere e.g. `attack_main2.py:1025-1028`).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from tpufusion_torch.core.imaging import _host, from_uint8, grid_montage, to_uint8


def save_image(array, path: str) -> str:
    """Save one image ((H,W,C) or (1,H,W,C)) as an 8-bit file."""
    arr = _host(array)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            return save_montage(arr, path)
        arr = arr[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(to_uint8(arr)).save(path)
    return path


def save_montage(batch, path: str, nrow: int = 8, padding: int = 2) -> str:
    """vutils.save_image-style grid for an (N,H,W,C) batch."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    grid = grid_montage(batch, nrow=nrow, padding=padding)
    Image.fromarray(to_uint8(grid)).save(path)
    return path


def save_comparison_grid(rows, path: str, titles=("Input", "Target", "Output")) -> str:
    """Input/target/output comparison figure (``utils/common.py vis_faces``
    analog, PIL-based): ``rows`` is a list of dicts with ``input_face`` /
    ``target_face`` / ``output_face`` images ((H,W,C) in [-1,1])."""
    panels = []
    for row in rows:
        trio = [row["input_face"], row["target_face"], row["output_face"]]
        panels.append(np.concatenate([_host(t) for t in trio], axis=1))
    grid = np.concatenate(panels, axis=0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(to_uint8(grid)).save(path)
    return path


def load_image(path: str, size: int | tuple | None = None) -> np.ndarray:
    """File -> (1, H, W, C) float32 numpy in [-1, 1]; optional bilinear
    resize (the target-image transform, `attack_main2.py:941-945`)."""
    img = Image.open(path).convert("RGB")
    if size is not None:
        if isinstance(size, int):
            size = (size, size)
        img = img.resize((size[1], size[0]), Image.BILINEAR)
    return from_uint8(np.asarray(img))[None]

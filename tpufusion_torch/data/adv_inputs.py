"""Pre-generated adversarial input loading (copy of
``tpufusion/data/adv_inputs.py``) — the ``adv_generate`` attack
(reference `inter_copy.py:391-395`, `interpolation.py:1377-1394`).

Two source formats the reference uses:
- a saved ``all_adv_inputs.npz`` artifact (ArtifactStore format here);
- a montage JPEG of N panels with 2px vutils padding, cropped per panel
  (`interpolation.py:1390-1394`: panel i spans columns
  [i*S + 2, i*S + 2 + S) and rows [2, 2+S)).
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from tpufusion_torch.core.imaging import from_uint8
from tpufusion_torch.io.artifacts import ArtifactStore


def crop_montage_panels(path: str, n: int, size: int, padding: int = 2) -> np.ndarray:
    """Montage image -> (n, size, size, 3) float32 in [-1, 1]."""
    arr = from_uint8(np.asarray(Image.open(path).convert("RGB")))
    panels = []
    for i in range(n):
        x0 = i * (size + padding) + padding
        panels.append(arr[padding : padding + size, x0 : x0 + size])
    return np.stack(panels)


def load_adv_inputs(path: str, n: int, size: int) -> np.ndarray:
    """Dispatch on file type: .npz artifact or montage image."""
    if path.endswith(".npz"):
        data = ArtifactStore.load(path)
        if data.shape[0] < n:
            raise ValueError(f"{path} holds {data.shape[0]} images, need {n}")
        return np.asarray(data[:n], np.float32)
    if path.lower().endswith((".jpg", ".jpeg", ".png")):
        return crop_montage_panels(path, n, size)
    raise ValueError(f"unsupported adversarial-input source: {path!r}")

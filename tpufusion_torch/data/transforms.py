"""Per-dataset transform configs (copy of ``tpufusion/data/transforms.py``)
— reference C17
(`transforms_config.py:15-69`, registry `data_configs.py:5-48`).

The reference composes torchvision Resize -> ToTensor -> Normalize(.5,.5);
here a transform is a plain callable PIL -> NHWC-row float32 in [-1, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
from PIL import Image


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """Resolution table per dataset family:
    test transform 1024^2 for faces (`transforms_config.py:28-31`),
    512^2 for cars (`:60-63`); inference/encoder-side 256^2 (`:35-38`)."""

    test_size: Tuple[int, int]
    inference_size: Tuple[int, int] = (256, 256)
    train_size: Tuple[int, int] = (256, 256)


# dataset_type registry (`data_configs.py`): every family except cars uses
# the face-style transforms.
DATASET_REGISTRY = {
    "ffhq_encode": TransformConfig(test_size=(1024, 1024)),
    "cars_encode": TransformConfig(test_size=(512, 512), train_size=(192, 256),
                                   inference_size=(192, 256)),
    "church_encode": TransformConfig(test_size=(256, 256)),
    "horse_encode": TransformConfig(test_size=(256, 256)),
    "cats_encode": TransformConfig(test_size=(256, 256)),
    "cifar10_encode": TransformConfig(test_size=(32, 32), inference_size=(32, 32)),
}


def dataset_type_for(dataset: str) -> str:
    if "car" in dataset:
        return "cars_encode"
    if "church" in dataset:
        return "church_encode"
    return "ffhq_encode"


def _resize_normalize(size: Tuple[int, int], flip_prob: float = 0.0,
                      rng: np.random.RandomState | None = None):
    from tpufusion_torch.data import native

    def apply(img: Image.Image) -> np.ndarray:
        # fused resize+normalize in the native host library when available
        # (one C pass instead of PIL resize + two numpy passes)
        arr = native.resize_normalize(np.asarray(img, dtype=np.uint8), *size)
        if flip_prob > 0.0 and (rng or np.random).rand() < flip_prob:
            arr = np.ascontiguousarray(arr[:, ::-1])
        return arr  # [-1, 1] (Normalize(mean .5, std .5))

    return apply


def transform_for(dataset: str, split: str = "test") -> Callable:
    """Return the PIL->array transform for a dataset/split (mirrors
    ``transforms_dict['transform_%s' % split]``)."""
    cfg = DATASET_REGISTRY[dataset_type_for(dataset)]
    if split == "test":
        return _resize_normalize(cfg.test_size)
    if split == "inference":
        return _resize_normalize(cfg.inference_size)
    if split == "gt_train":
        return _resize_normalize(cfg.train_size, flip_prob=0.5)
    raise ValueError(f"split must be test/inference/gt_train, got {split!r}")

from tpufusion_torch.data.alignment import FFHQ_LANDMARK_SLICES, align_face
from tpufusion_torch.data.dataset import (
    IMG_EXTENSIONS,
    BatchLoader,
    ImageFolderDataset,
    list_images,
    setup_loaders,
)
from tpufusion_torch.data.transforms import (
    DATASET_REGISTRY,
    TransformConfig,
    transform_for,
)

__all__ = ["DATASET_REGISTRY", "FFHQ_LANDMARK_SLICES", "IMG_EXTENSIONS", "BatchLoader",
           "ImageFolderDataset", "TransformConfig", "align_face", "list_images",
           "setup_loaders", "transform_for"]

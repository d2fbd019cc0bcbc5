from tpufusion_torch.models.e4e import Encoder4Editing
from tpufusion_torch.models.fusion_hierarchy import (
    TREES,
    HierarchyBlender,
    get_all_active_parts,
)
from tpufusion_torch.models.stylegan2 import Generator, GeneratorOutput, channel_map
from tpufusion_torch.models.vgg16 import VGG16, perceptual_distance

__all__ = ["Encoder4Editing", "Generator", "GeneratorOutput", "HierarchyBlender", "TREES",
           "VGG16", "channel_map", "get_all_active_parts", "perceptual_distance"]

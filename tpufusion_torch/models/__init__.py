from tpufusion_torch.models.discriminator import (
    Discriminator,
    create_discriminator,
    load_ada_discriminator,
    realism_scores,
)
from tpufusion_torch.models.e4e import Encoder4Editing
from tpufusion_torch.models.fusion_hierarchy import (
    TREES,
    HierarchyBlender,
    get_all_active_parts,
)
from tpufusion_torch.models.lpips import LPIPS, convert_torch_lpips, load_torch_lpips
from tpufusion_torch.models.stylegan2 import Generator, GeneratorOutput, channel_map
from tpufusion_torch.models.resnet import ResNet, create_resnet18
from tpufusion_torch.models.vgg16 import VGG16, perceptual_distance
from tpufusion_torch.models.vit import ViTClassifier, create_vit

__all__ = ["Discriminator", "Encoder4Editing", "Generator", "GeneratorOutput",
           "HierarchyBlender", "LPIPS", "ResNet", "TREES", "VGG16", "ViTClassifier",
           "channel_map", "convert_torch_lpips", "create_discriminator", "create_resnet18",
           "create_vit", "get_all_active_parts", "load_ada_discriminator", "load_torch_lpips",
           "perceptual_distance", "realism_scores"]

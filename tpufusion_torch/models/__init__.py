from tpufusion_torch.models.e4e import Encoder4Editing
from tpufusion_torch.models.stylegan2 import Generator, GeneratorOutput, channel_map
from tpufusion_torch.models.vgg16 import VGG16, perceptual_distance

__all__ = ["Encoder4Editing", "Generator", "GeneratorOutput", "VGG16", "channel_map",
           "perceptual_distance"]

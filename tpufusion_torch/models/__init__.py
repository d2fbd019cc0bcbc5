from tpufusion_torch.models.e4e import Encoder4Editing
from tpufusion_torch.models.stylegan2 import Generator, GeneratorOutput, channel_map

__all__ = ["Encoder4Editing", "Generator", "GeneratorOutput", "channel_map"]

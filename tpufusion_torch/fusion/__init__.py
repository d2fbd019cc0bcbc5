from tpufusion_torch.fusion.arithmetic import arithmetic_fusion
from tpufusion_torch.fusion.drawer import DATASET_SIZE, FusionDrawer

__all__ = ["DATASET_SIZE", "FusionDrawer", "arithmetic_fusion"]

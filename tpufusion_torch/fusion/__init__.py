from tpufusion_torch.fusion.arithmetic import arithmetic_fusion
from tpufusion_torch.fusion.drawer import DATASET_CONFIG, SWAP_TABLE, FusionDrawer
from tpufusion_torch.fusion.spatial import (
    ROLE_MAPS,
    n_inputs,
    recon_index,
    spatial_fused,
    spatial_fusion,
)

__all__ = ["DATASET_CONFIG", "FusionDrawer", "ROLE_MAPS", "SWAP_TABLE", "arithmetic_fusion",
           "n_inputs", "recon_index", "spatial_fused", "spatial_fusion"]

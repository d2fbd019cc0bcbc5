from tpufusion_torch.attacks.fusion_attack import (
    FusionAttackConfig,
    fgsm_on_fusion,
    make_fused_image_fn,
    make_fusion_attack,
    make_fusion_loss,
)
from tpufusion_torch.attacks.pgd import PGDConfig, fgsm, make_pgd, pgd_random_start

__all__ = [
    "FusionAttackConfig", "PGDConfig", "fgsm", "fgsm_on_fusion", "make_fused_image_fn",
    "make_fusion_attack", "make_fusion_loss", "make_pgd", "pgd_random_start",
]

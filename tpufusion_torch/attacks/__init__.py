from tpufusion_torch.attacks.fusion_attack import (
    FusionAttackConfig,
    fgsm_on_fusion,
    make_fused_image_fn,
    make_fusion_attack,
    make_fusion_loss,
)
from tpufusion_torch.attacks.pgd import PGDConfig, fgsm, make_pgd, pgd_random_start
from tpufusion_torch.attacks.whitebox import (
    PRESET_ATTACK_MAIN,
    PRESET_INTERPOLATION,
    LossWeights,
    WhiteboxConfig,
    default_n_iters,
    make_per_image_whitebox,
    make_whitebox_attack,
    make_whitebox_stepper,
    run_whitebox,
    run_whitebox_stepwise,
)

__all__ = [
    "FusionAttackConfig", "LossWeights", "PGDConfig", "PRESET_ATTACK_MAIN",
    "PRESET_INTERPOLATION", "WhiteboxConfig", "default_n_iters", "fgsm", "fgsm_on_fusion",
    "make_fused_image_fn", "make_fusion_attack", "make_fusion_loss", "make_per_image_whitebox",
    "make_pgd", "make_whitebox_attack", "make_whitebox_stepper", "pgd_random_start",
    "run_whitebox", "run_whitebox_stepwise",
]

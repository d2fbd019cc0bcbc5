from tpufusion_torch.attacks.baselines import (
    dp_noise,
    gaussian_blur_noise,
    out_domain_more,
    out_domain_single,
    paste_patch,
)
from tpufusion_torch.attacks.cw import CWConfig, make_cw
from tpufusion_torch.attacks.fusion_attack import (
    FusionAttackConfig,
    fgsm_on_fusion,
    make_fused_image_fn,
    make_fusion_attack,
    make_fusion_loss,
)
from tpufusion_torch.attacks.hybrid import splice_hybrid
from tpufusion_torch.attacks.patch import (
    PatchConfig,
    apply_patch,
    canonical_canvas,
    circle_transform,
    init_patch_circle,
    init_patch_square,
    make_patch_attack_step,
    square_transform,
    submatrix,
    train_patch,
)
from tpufusion_torch.attacks.pgd import PGDConfig, fgsm, make_pgd, pgd_random_start
from tpufusion_torch.attacks.whitebox import (
    PRESET_ATTACK_MAIN,
    PRESET_INTERPOLATION,
    LegacyOptimizeConfig,
    LossWeights,
    WhiteboxConfig,
    default_n_iters,
    make_legacy_optimize,
    make_per_image_whitebox,
    make_whitebox_attack,
    make_whitebox_stepper,
    run_whitebox,
    run_whitebox_stepwise,
)

__all__ = [
    "CWConfig", "FusionAttackConfig", "LegacyOptimizeConfig", "LossWeights", "PGDConfig",
    "PRESET_ATTACK_MAIN", "PRESET_INTERPOLATION", "PatchConfig", "WhiteboxConfig", "apply_patch",
    "canonical_canvas", "circle_transform", "default_n_iters", "dp_noise", "fgsm",
    "fgsm_on_fusion", "gaussian_blur_noise", "init_patch_circle", "init_patch_square",
    "make_cw", "make_fused_image_fn", "make_fusion_attack", "make_fusion_loss",
    "make_legacy_optimize", "make_patch_attack_step", "make_per_image_whitebox", "make_pgd",
    "make_whitebox_attack", "make_whitebox_stepper", "out_domain_more", "out_domain_single",
    "paste_patch", "pgd_random_start", "run_whitebox", "run_whitebox_stepwise",
    "splice_hybrid", "square_transform", "submatrix", "train_patch",
]

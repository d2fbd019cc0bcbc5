from tpufusion_torch.eval.metrics import (
    fused_image_metrics,
    fused_image_metrics_with,
    input_noise_mse,
    latent_distance,
    mse_per_image,
    perceptual_distance_per_image,
    rgb_to_gray,
    ssim,
)
from tpufusion_torch.eval.partial import (
    benign_fusion,
    partial_adv_fusion,
    partial_latent_variants,
)
from tpufusion_torch.eval.report import ResultsTable

__all__ = ["benign_fusion", "fused_image_metrics", "fused_image_metrics_with",
           "input_noise_mse", "latent_distance",
           "mse_per_image", "partial_adv_fusion", "partial_latent_variants",
           "perceptual_distance_per_image", "ResultsTable", "rgb_to_gray", "ssim"]

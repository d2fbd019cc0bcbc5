from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.core.imaging import (
    avg_pool,
    clamp_pm1,
    from_uint8,
    grid_montage,
    montage,
    resize_bilinear,
    to_uint8,
)
from tpufusion_torch.core.prng import GLOBAL_SEED, PRNGPool, seed_everything

__all__ = ["GLOBAL_SEED", "PRNGPool", "Policy", "avg_pool", "clamp_pm1", "default_policy",
           "from_uint8", "grid_montage", "montage", "resize_bilinear", "resolve_device",
           "seed_everything", "to_uint8"]

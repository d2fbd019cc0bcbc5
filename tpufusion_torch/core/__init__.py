from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.core.imaging import avg_pool, clamp_pm1

__all__ = ["Policy", "default_policy", "resolve_device", "avg_pool", "clamp_pm1"]

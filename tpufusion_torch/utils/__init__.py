from tpufusion_torch.utils.logging import EasyDict, Logger, trace_profile
from tpufusion_torch.utils.resources import make_cache_dir_path, open_url, set_cache_dir

__all__ = ["EasyDict", "Logger", "make_cache_dir_path", "open_url", "set_cache_dir",
           "trace_profile"]

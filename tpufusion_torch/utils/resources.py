"""Resource opening + cache dirs (copy of ``tpufusion/utils/resources.py``;
the rest of reference C21, `dnnlib/util.py:120-136` cache dirs,
`:364-477` ``open_url``).

The reference's ``open_url`` downloads checkpoints with retries and a local
cache; this environment has zero egress, so network URLs raise a clear error
while file paths / ``file://`` URLs (the only sources the attack code
actually uses at runtime) open directly, with optional copy-through caching.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from typing import IO


_CACHE_DIR = None


def set_cache_dir(path: str) -> None:
    global _CACHE_DIR
    _CACHE_DIR = path


def make_cache_dir_path(*paths: str) -> str:
    base = _CACHE_DIR or os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "tpufusion",
    )
    path = os.path.join(base, *paths)
    os.makedirs(path, exist_ok=True)
    return path


def is_url(obj) -> bool:
    return isinstance(obj, str) and "://" in obj


def open_url(url: str, cache: bool = True, cache_dir: str | None = None) -> IO[bytes]:
    """Open a local path or file:// URL (optionally copy-through cached).
    Network schemes raise: this deployment has no egress — convert
    checkpoints offline and point at local files."""
    if url.startswith("file://"):
        url = url[len("file://") :]
    if is_url(url):
        raise RuntimeError(
            f"network fetch not available in this deployment: {url!r}; "
            "download offline and pass a local path"
        )
    if not os.path.exists(url):
        raise FileNotFoundError(url)
    if cache:
        digest = hashlib.md5(os.path.abspath(url).encode()).hexdigest()[:16]
        dest = os.path.join(
            cache_dir or make_cache_dir_path("downloads"),
            f"{digest}_{os.path.basename(url)}",
        )
        if not os.path.exists(dest):
            shutil.copyfile(url, dest)
        return open(dest, "rb")
    return open(url, "rb")

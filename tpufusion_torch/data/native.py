"""ctypes bindings for the native host-ops library (native/host_ops.cpp);
the port's own binding, a copy of ``tpufusion/data/native.py``.

Auto-builds ``libtpufusion_host.so`` with g++ on first use if missing; every
entry point has a numpy fallback so the framework works without a compiler.
The native path removes GIL-bound per-pixel Python work from the decode ->
resize -> normalize loader loop (the reference gets this from torch's C++).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_LOCK = threading.Lock()
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libtpufusion_host.so")

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR], check=True,
                    capture_output=True, timeout=120,
                )
            except Exception:
                _LIB = False
                return _LIB
        try:
            lib = ctypes.CDLL(_SO_PATH)
            lib.normalize_u8_to_pm1.argtypes = [_u8p, _f32p, ctypes.c_int64]
            lib.pm1_to_u8.argtypes = [_f32p, _u8p, ctypes.c_int64]
            lib.resize_bilinear_u8_to_pm1.argtypes = [
                _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _f32p, ctypes.c_int, ctypes.c_int,
            ]
            lib.avg_pool_pm1.argtypes = [
                _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _f32p,
            ]
            lib.montage_strip_pm1.argtypes = [
                _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, _f32p,
            ]
            _LIB = lib
        except Exception:
            _LIB = False
        return _LIB


def available() -> bool:
    return bool(_load())


def normalize_u8_to_pm1(src: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 [-1,1] (fused ToTensor+Normalize)."""
    src = np.ascontiguousarray(src, np.uint8)
    lib = _load()
    out = np.empty(src.shape, np.float32)
    if lib:
        lib.normalize_u8_to_pm1(src.reshape(-1), out.reshape(-1), src.size)
        return out
    return src.astype(np.float32) / 255.0 * 2.0 - 1.0


def pm1_to_u8(src: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(src, np.float32)
    lib = _load()
    if lib:
        out = np.empty(src.shape, np.uint8)
        lib.pm1_to_u8(src.reshape(-1), out.reshape(-1), src.size)
        return out
    return (np.clip((src + 1.0) / 2.0, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def resize_normalize(src: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 HWC -> resized float32 [-1,1] HWC, one fused native pass."""
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, c = src.shape
    lib = _load()
    if lib:
        out = np.empty((height, width, c), np.float32)
        lib.resize_bilinear_u8_to_pm1(src.reshape(-1), sh, sw, c,
                                      out.reshape(-1), height, width)
        return out
    # numpy fallback: PIL-free bilinear, half-pixel convention — must match
    # the native kernel EXACTLY: weights from the UNCLAMPED floor, both taps
    # clamped from it (so out-of-range coords clamp to the edge row/col
    # instead of blending toward the interior — the old clipped-floor code
    # blended row/col 1 at the top/left edge on upscales)
    yy = (np.arange(height) + 0.5) * (sh / height) - 0.5
    xx = (np.arange(width) + 0.5) * (sw / width) - 0.5
    y0f = np.floor(yy).astype(int)
    x0f = np.floor(xx).astype(int)
    y0 = np.clip(y0f, 0, sh - 1)
    y1 = np.clip(y0f + 1, 0, sh - 1)
    x0 = np.clip(x0f, 0, sw - 1)
    x1 = np.clip(x0f + 1, 0, sw - 1)
    wy = (yy - y0f)[:, None, None]
    wx = (xx - x0f)[None, :, None]
    s = src.astype(np.float32)
    top = s[y0][:, x0] * (1 - wx) + s[y0][:, x1] * wx
    bot = s[y1][:, x0] * (1 - wx) + s[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out / 255.0 * 2.0 - 1.0


def avg_pool(src: np.ndarray, factor: int) -> np.ndarray:
    """float32 NHWC average pool by integer factor."""
    src = np.ascontiguousarray(src, np.float32)
    n, h, w, c = src.shape
    lib = _load()
    if lib:
        out = np.empty((n, h // factor, w // factor, c), np.float32)
        lib.avg_pool_pm1(src.reshape(-1), n, h, w, c, factor, out.reshape(-1))
        return out
    return src.reshape(n, h // factor, factor, w // factor, factor, c).mean((2, 4))


def montage_strip(src: np.ndarray, padding: int = 2, pad_value: float = -1.0) -> np.ndarray:
    """float32 (N,H,W,C) -> horizontal strip with padding."""
    src = np.ascontiguousarray(src, np.float32)
    n, h, w, c = src.shape
    lib = _load()
    if lib:
        out = np.empty((h + 2 * padding, n * (w + padding) + padding, c), np.float32)
        lib.montage_strip_pm1(src.reshape(-1), n, h, w, c, padding,
                              float(pad_value), out.reshape(-1))
        return out
    from tpufusion_torch.core.imaging import montage

    return montage(src, padding=padding, pad_value=pad_value)

"""Build and load the hand-written Hopper kernels (``tpufusion_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, ``build/tpufusion_torch/lib<name>.so`` under the
repository root, loaded with ``ctypes``. All sources build together, one
``nvcc`` per source started at once, the first time any kernel is needed; a
library is rebuilt when a source under ``csrc/`` is newer than it.

Nothing here falls back: a missing ``nvcc``, a failed build or a failed load
raises, and the wrappers in ``ops/`` let it propagate.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpufusion_torch"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Each source's C entries and their argument types (all return a cudaError_t
# as int). ``load`` declares them once, so the wrappers call them directly.
SIGNATURES = {
    "styled_conv": {"tf_styled_conv_fwd": [_P] * 7 + [_I] * 6 + [_P]},
    "conv3x3": {"tf_conv3x3_fwd": [_P] * 3 + [_I] * 5 + [_P],
                "tf_conv3x3_wgrad": [_P] * 4 + [_I] * 6 + [_P]},
    "pgd_update": {"tf_pgd_update": [_P] * 4 + [ctypes.c_longlong, _I, _I]
                   + [_F] * 4 + [_P]},
    "adam_update": {"tf_adam_update": [_P] * 4 + [ctypes.c_longlong, _I] + [_F] * 3 + [_P]},
}
SOURCES = tuple(SIGNATURES)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the tpufusion_torch kernels are built from "
        "tpufusion_torch/csrc at first use and need the CUDA toolkit")


def _stale(name: str) -> bool:
    so = BUILD_DIR / f"lib{name}.so"
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return so.stat().st_mtime < newest


def build(names=SOURCES) -> float:
    """Compile the given sources in parallel; returns the wall seconds."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, BUILD_DIR / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so`` with its entries' signatures
    declared, building every stale source first."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    stale = [n for n in SOURCES if n not in _LIBS and _stale(n)]
    if stale:
        build(stale)
    lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t) -> int:
    """The C entries' dtype argument; raises for anything but fp32/bf16."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]

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
    "styled_conv": {"tf_styled_conv_fwd": [_P] * 7 + [_I] * 7 + [_P]},
    "conv3x3": {"tf_conv3x3_fwd": [_P] * 3 + [_I] * 6 + [_P],
                "tf_conv3x3_wgrad": [_P] * 4 + [_I] * 6 + [_P]},
    "pgd_update": {"tf_pgd_update": [_P] * 4 + [ctypes.c_longlong, _I] + [_F] * 4 + [_P]},
    "adam_update": {"tf_adam_update": [_P] * 4 + [ctypes.c_longlong, _F, _P, _I, _P, _P]},
}
SOURCES = tuple(SIGNATURES)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

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
    """Compile the given sources in parallel; returns the wall seconds.
    nvcc's output (``-Xptxas=-v``: registers and spills per kernel) goes to
    ``<name>.ptxas.txt`` beside each library."""
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
            (BUILD_DIR / f"{name}.ptxas.txt").write_text(out)
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


# what the bf16 conv entries return, plus the CUresult, when x's TMA tensor
# map cannot be encoded (csrc/conv3x3_wgmma.cuh)
TENSOR_MAP_ERROR = 100000


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError``,
    a refused ``cudaFuncSetAttribute``) or could not encode a tensor map."""
    if rc >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with CUresult "
                           f"{rc - TENSOR_MAP_ERROR}")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def aligned16(t):
    """``t``, or a contiguous copy of it where ``t`` does not start on a
    16-byte boundary (a view at an odd offset): the bf16 conv kernels read
    their inputs by TMA (a 16-byte aligned base) and 16-byte copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


# PyTorch's raw handle of a device's current stream, without building a
# ``Stream`` object. The binding is private, so where a build of PyTorch
# lacks it the public ``torch.cuda.current_stream(index).cuda_stream`` (the
# same handle) takes its place.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream_handle(index: int) -> int:
    """The raw ``cudaStream_t`` of device ``index``'s current stream."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(entry, t, what: str, *args) -> None:
    """Call the C entry ``entry(*args, stream)`` on the current stream of
    ``t``'s device, with the CUDA runtime's current device set to it, and
    raise on its error. A C entry launches on the runtime's current device,
    so without the guard a tensor on ``cuda:1`` in a process whose current
    device is ``cuda:0`` would be launched on the wrong card. The guard is
    entered only when the devices differ, and the stream is read as a raw
    handle (``current_stream_handle``): a launch costs a few microseconds
    of host time, the length of a small plane's kernel."""
    index = t.get_device()
    if index == torch.cuda.current_device():
        rc = entry(*args, current_stream_handle(index))
    else:
        with torch.cuda.device(index):
            rc = entry(*args, current_stream_handle(index))
    check(rc, what)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t) -> int:
    """The C entries' dtype argument; raises for anything but fp32/bf16."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]

"""Dtype policy and device resolution (port of ``tpufusion/core/dtypes.py``).

Parameters are stored fp32 and reductions (losses, statistics, demodulation
sums) accumulate in fp32 everywhere. Compute runs in bf16 on the card and in
fp32 on the CPU, so CPU parity tests compare fp32 against fp32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: ``compute_dtype`` is the dtype activations and
    weights are cast to inside layers. Parameters are always stored float32
    and reductions (losses, statistics, demodulation sums) accumulate in
    float32, as the JAX package's default policy has it."""

    compute_dtype: torch.dtype = torch.float32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another. Never falls back to the CPU: asking for CUDA where there is none
    raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpufusion_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def default_policy(device) -> Policy:
    """fp32 params everywhere; bf16 compute on CUDA, fp32 on the CPU."""
    if torch.device(device).type == "cuda":
        return Policy(compute_dtype=torch.bfloat16)
    return Policy()

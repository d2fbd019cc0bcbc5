"""tpufusion_torch — the PyTorch / CUDA (Hopper) port of ``tpufusion``.

The JAX package ``tpufusion`` is the reference; this package mirrors its
module paths (``tpufusion_torch/ops/styled_conv.py`` <->
``tpufusion/ops/styled_conv.py`` and so on) and is held against it by the
``tests/test_torch_*.py`` parity tests.

Conventions:
- public functions take and return NHWC activations, as the JAX package does;
- parameters carry rosinality ``g_ema`` and e4e ``encoder.`` state-dict names
  and shapes, so the published checkpoints load with ``load_state_dict``;
- entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
- every TPU Pallas kernel on the ported path is a hand-written CUDA kernel
  (``csrc/``) with a plain PyTorch twin in the same module. The twin runs for
  CPU tensors only; a CUDA tensor launches the kernel or raises.

This package imports ``torch`` and ``numpy`` only — never ``jax`` and nothing
of ``tpufusion``.
"""

__all__ = ["core", "ops", "models", "fusion", "attacks", "eval", "io", "pipeline", "configs",
           "data", "utils", "runner", "cli"]

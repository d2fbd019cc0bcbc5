"""Fused Adam pixel update: moments, bias correction and step in one pass
(port of ``tpufusion/ops/adam_update.py``).

One ``optax.adam(lr)``-default step (b1 0.9, b2 0.999, eps 1e-8) over the
white-box attack's float32 pixel buffer (`attack_main2.py:614`
``optim.Adam([X])``):

    mu  <- b1*mu + (1-b1)*g          nu  <- b2*nu + (1-b2)*g*g
    x   <- x - lr * (mu / bc1) / (sqrt(nu / bc2) + eps)

with ``bc1 = 1 - b1**t`` and ``bc2 = 1 - b2**t`` in float32. This is the JAX
package's order of operations, not ``torch.optim.Adam``'s (which divides by
``sqrt(bc2)`` outside the root and differs by ulps).

The bias corrections live on the device: ``bias_table`` fills a float32
(``TABLE_ROWS``, 2) table once per device with ``bias_corrections``' numpy
arithmetic (row ``r`` is step ``t = r + 1``; from the last row on, every
step rounds to (1, 1)), and the kernel reads row ``min(count, rows - 1)``
through a pointer to a device int. A state's ``count`` is either a Python
int (the host loops: the step's row is read through ``step_index``, an
arange on the device) or, from ``adam_init(x, on_device=True)``, a 0-dim
int32 tensor that each step advances in place: a step captured in a CUDA
graph (``core/graphs.py``) then reads the next row on every replay.

Kernel: ``csrc/adam_update.cu``, replacing the TPU kernel
``tpufusion/ops/adam_update.py::_pallas_adam`` (``_adam_kernel``). It is
bound by the bytes it moves (four reads, three writes): 16-byte
evict-first loads and stores, a block per 256 vectors
(``csrc/pixel_stream.cuh``). ``x``, ``mu`` and ``nu`` are updated
in place, as the TPU kernel aliases them. The TPU kernel's ``size % 1024``
gate is gone: any size is taken.

``adam_update_plain`` is the same step in plain PyTorch, rounding after every
operation as the kernel does; ``fused_adam`` uses it for CPU tensors only.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufusion_torch.core import trace
from tpufusion_torch.ops import _lib

B1, B2, EPS = 0.9, 0.999, 1e-8


# the table's rows: from step 17321 on, 1 - b1**t and 1 - b2**t both round
# to 1.0 in float32 (tests/test_torch_graphs.py holds it)
TABLE_ROWS = 17321

_TABLES: dict = {}


def adam_init(x: torch.Tensor, *, on_device: bool = False) -> dict:
    """Moment state for ``fused_adam``: zero moments and a step count, a
    Python int (the host never waits on the device for it) or, with
    ``on_device``, a 0-dim int32 tensor on ``x``'s device that ``fused_adam``
    advances in place. Also builds the device's bias table, so that a step
    captured later finds it."""
    if on_device:
        count = torch.zeros((), dtype=torch.int32, device=x.device)
        bias_table(x.device)
    else:
        count = 0
    return dict(mu=torch.zeros_like(x), nu=torch.zeros_like(x), count=count)


def bias_corrections(count: int):
    """``(1 - b1**t, 1 - b2**t)`` in float32 for step ``t = count``."""
    t = np.float32(count)
    one = np.float32(1.0)
    return float(one - np.float32(B1) ** t), float(one - np.float32(B2) ** t)


def _table_rows() -> np.ndarray:
    # one scalar power a row, as ``bias_corrections`` takes it: numpy's
    # vectorised float32 power rounds some rows differently
    return np.array([bias_corrections(t) for t in range(1, TABLE_ROWS + 1)], np.float32)


def bias_table(device) -> torch.Tensor:
    """The float32 (TABLE_ROWS, 2) bias-correction table on ``device``, built
    once: row ``r`` holds ``bias_corrections(r + 1)``."""
    device = torch.device(device)
    if device not in _TABLES:
        _TABLES[device] = (torch.from_numpy(_table_rows()).to(device),
                           torch.arange(TABLE_ROWS, dtype=torch.int32, device=device))
    return _TABLES[device][0]


def step_index(device, count: int) -> torch.Tensor:
    """A 0-dim int32 device tensor holding ``min(count, TABLE_ROWS - 1)``: a
    view into the device's arange, so a host count costs no copy."""
    bias_table(device)
    return _TABLES[torch.device(device)][1][min(count, TABLE_ROWS - 1)]


def adam_update_plain(x, g, mu, nu, lr, bc1, bc2):
    """The kernel's arithmetic in plain PyTorch, in place on ``x``, ``mu``
    and ``nu``. ``bc1`` and ``bc2`` are floats or 0-dim float32 tensors (a
    row of ``bias_table``); they divide as 0-dim tensors on ``x``'s device:
    a Python scalar divisor would become a multiply by its reciprocal on
    CUDA and round differently."""
    bc1_t = torch.as_tensor(bc1, dtype=torch.float32, device=x.device)
    bc2_t = torch.as_tensor(bc2, dtype=torch.float32, device=x.device)
    mu.mul_(B1).add_(g * (1.0 - B1))
    nu.mul_(B2).add_(g * (1.0 - B2) * g)
    step = (mu / bc1_t) / ((nu / bc2_t).sqrt() + EPS)
    x.sub_(step * lr)
    return x, mu, nu


def _check_like(name, t, x):
    if t.dtype != torch.float32:
        raise TypeError(f"fused_adam: {name} must be float32, got {t.dtype}")
    if t.shape != x.shape or t.device != x.device:
        raise ValueError(f"fused_adam: {name} must match x in shape and device, "
                         f"got {tuple(t.shape)} {t.device}")


def _check_cuda(name, t):
    if not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"fused_adam: {name} must be a contiguous CUDA tensor")


def adam_update_kernel(x, g, mu, nu, lr, table, step):
    """Launch the kernel on contiguous float32 CUDA tensors of one shape;
    ``x``, ``mu`` and ``nu`` are written in place. The bias corrections are
    row ``min(step, rows - 1)`` of ``table`` (float32 (rows, 2), from
    ``bias_table``), ``step`` a 0-dim int32 tensor on the same device, read
    by the kernel. Every check raises before the library is built or
    loaded."""
    _check_like("x", x, x)
    _check_like("g", g, x)
    _check_like("mu", mu, x)
    _check_like("nu", nu, x)
    _check_cuda("x", x)
    _check_cuda("g", g)
    _check_cuda("mu", mu)
    _check_cuda("nu", nu)
    if (table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != 2
            or not table.is_contiguous() or step.dtype != torch.int32 or step.numel() != 1
            or table.device != x.device or step.device != x.device):
        raise ValueError("fused_adam: table must be a contiguous float32 (rows, 2) and step "
                         "an int32 scalar, both on x's device")
    fn = _lib.load("adam_update").tf_adam_update
    _lib.launch(fn, x, "fused_adam", x.data_ptr(), g.data_ptr(), mu.data_ptr(),
                nu.data_ptr(), x.numel(), float(lr), table.data_ptr(), table.shape[0],
                step.data_ptr())
    return x, mu, nu


def fused_adam(x: torch.Tensor, g: torch.Tensor, state: dict, lr):
    """One Adam step over a pixel buffer, in place on ``x`` and the moments.
    Returns ``(x, state)`` with the step count advanced: a new state dict
    for a Python count, the same dict (its count tensor advanced in place)
    for a device count. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    count = state["count"]
    on_device = isinstance(count, torch.Tensor)
    if x.device.type == "cpu":
        row = bias_table(x.device)[min(int(count), TABLE_ROWS - 1)]
        adam_update_plain(x, g, state["mu"], state["nu"], lr, row[0], row[1])
    else:
        step = count if on_device else step_index(x.device, count)
        adam_update_kernel(x, g, state["mu"], state["nu"], lr, bias_table(x.device), step)
        trace.count("fused_adam")
    if on_device:
        count.add_(1)
        return x, state
    return x, dict(mu=state["mu"], nu=state["nu"], count=count + 1)

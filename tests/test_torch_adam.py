"""Parity of the port's fused Adam pixel update with the JAX package.

- ``adam_update_plain`` (the kernel's arithmetic) matches ``_xla_adam`` and
  the Pallas kernel ``_pallas_adam`` run in interpret mode, as
  ``tests/test_ops.py`` runs it;
- the float32 bias corrections match JAX's ``1 - b**t``;
- a 7-step ``fused_adam`` trajectory matches JAX's ``fused_adam``, at a size
  the Pallas kernel takes and at an odd size JAX sends to its XLA path;
- on CPU tensors ``fused_adam`` updates in place and launches no kernel.
CPU, float32; atol 1e-6 as in ``tests/test_ops.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufusion.ops.adam_update import _pallas_adam, _xla_adam
from tpufusion.ops.adam_update import adam_init as j_adam_init
from tpufusion.ops.adam_update import fused_adam as j_fused_adam
from tpufusion_torch.ops import adam_update as au
from tpufusion_torch.ops import launch_counts


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    mu = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    nu = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
    return x, g, mu, nu


def test_plain_matches_xla_and_pallas_interpret():
    x, g, mu, nu = _inputs((2, 16, 16, 4), 3)
    args = (1e-2, 0.19, 0.002996)
    got = au.adam_update_plain(*map(torch.from_numpy, (x.copy(), g, mu.copy(), nu.copy())),
                               *args)
    jargs = tuple(map(jnp.asarray, (x, g, mu, nu))) + args
    for want in (_xla_adam(*jargs), _pallas_adam(*jargs, interpret=True)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("count", [1, 2, 7, 50, 1000])
def test_bias_corrections_match_jax(count):
    t = jnp.asarray(count, jnp.int32).astype(jnp.float32)
    bc1, bc2 = au.bias_corrections(count)
    np.testing.assert_allclose(bc1, float(1.0 - 0.9 ** t), rtol=2e-7, atol=0)
    np.testing.assert_allclose(bc2, float(1.0 - 0.999 ** t), rtol=2e-7, atol=0)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (3, 7, 5, 3)])
def test_trajectory_matches_jax(shape):
    """Bias correction drifts if the count handling is off by one; (3, 7, 5, 3)
    is a size JAX's Pallas gate (``size % 1024``) sends to XLA."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, shape).astype(np.float32)
    grads = [rng.standard_normal(shape).astype(np.float32) for _ in range(7)]
    jx, jst = jnp.asarray(x0), j_adam_init(jnp.asarray(x0))
    tx = torch.from_numpy(x0.copy())
    tst = au.adam_init(tx)
    for g in grads:
        jx, jst = j_fused_adam(jx, jnp.asarray(g), jst, 1e-2)
        tx, tst = au.fused_adam(tx, torch.from_numpy(g), tst, 1e-2)
    assert tst["count"] == int(jst["count"]) == 7
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tst["mu"].numpy(), np.asarray(jst["mu"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tst["nu"].numpy(), np.asarray(jst["nu"]), atol=1e-6, rtol=0)


def test_cpu_updates_in_place_without_a_launch():
    x, g, _, _ = map(torch.from_numpy, _inputs((1, 5, 5, 3), 7))
    st = au.adam_init(x)
    before = launch_counts()["fused_adam"]
    x2, st2 = au.fused_adam(x, g, st, 0.1)
    assert x2 is x and st2["mu"] is st["mu"] and st2["nu"] is st["nu"]
    assert st2["count"] == 1 and st["count"] == 0
    assert launch_counts()["fused_adam"] == before
    # first step from zero moments: x moves by lr * g / (|g| + eps)
    np.testing.assert_allclose(x.numpy(), (torch.from_numpy(_inputs((1, 5, 5, 3), 7)[0])
                                           - 0.1 * g / (g.abs() + 1e-8)).numpy(),
                               atol=1e-6, rtol=0)

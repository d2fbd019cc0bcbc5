"""``chip_smoke.py``'s kernel check fails a kernel whose output is not finite.

The script's error helpers take ``torch`` as an argument and run on CPU
tensors, so they are checked here without a card.
"""

import importlib.util
import math
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf])
@pytest.mark.parametrize("tol", [0.0, 1e-3, 3e-2])
def test_non_finite_output_fails(smoke, bad, tol):
    ref = torch.ones(4, 4)
    got = ref.clone()
    got[1, 2] = bad
    err, rel = smoke._err(torch, got, ref)
    assert err == rel == math.inf
    assert not smoke._within(err, rel, tol)


def test_finite_output_is_held_to_tol(smoke):
    ref = torch.full((3,), 4.0)
    err, rel = smoke._err(torch, ref + torch.tensor([0.0, 0.02, 0.0]), ref)
    assert err == pytest.approx(0.02) and rel == pytest.approx(0.005)
    assert smoke._within(err, rel, 1e-2) and not smoke._within(err, rel, 1e-3)
    assert smoke._within(*smoke._err(torch, ref, ref), 0.0)

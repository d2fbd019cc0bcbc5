"""Every kernel launches on its tensor's card (``ops/_lib.py::launch``).

The C entries launch on the CUDA runtime's current device: without the
guard a tensor on ``cuda:1`` in a process whose current device is
``cuda:0`` would be launched on the wrong card. Each wrapper is called on
``cuda:1`` tensors with ``cuda:0`` current and held to its plain twin
there (float32, TF32 off: 1e-4 of max(1, max|plain|), pgd_update and
fused_adam bit-exact, as in ``tests/test_torch_cuda.py``); the current
device is left as it was. Needs two NVIDIA GPUs (marker ``cuda``) and
skips otherwise: the kernels run only on a card.
"""

import pytest
import torch

from tpufusion_torch.ops import adam_update as au
from tpufusion_torch.ops import conv3x3 as c3
from tpufusion_torch.ops import pgd_update as pu
from tpufusion_torch.ops import styled_conv as sc

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the guard matters when a tensor is not on the "
                    "current device")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    yield torch.device("cuda", 1), torch.Generator(device="cuda:1").manual_seed(0)
    torch.backends.cudnn.allow_tf32 = prev
    assert torch.cuda.current_device() == 0


def _close(got, want):
    assert got.device == want.device
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL * max(1.0, want.abs().max().item()), err


def test_kernels_launch_on_their_tensors_card(second_card):
    dev, g = second_card
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    x = rn(2, 16, 16, 32)
    args = (x, rn(3, 3, 32, 64), rn(2, 32) * 0.5 + 1, rn(1, 16, 16, 1),
            torch.tensor(0.2, device=dev), rn(64) * 0.1)
    _close(sc.styled_conv_kernel(*args), sc.styled_conv_plain(*args))
    w = rn(3, 3, 32, 32)
    _close(c3.conv3x3_forward_kernel(x, w), c3.conv3x3_plain(x, w))
    _close(c3.conv3x3_weight_grad_kernel(x, x), c3.conv3x3_weight_grad_plain(x, x))
    adv, grad = rn(2, 16, 16, 3), rn(2, 16, 16, 3)
    img = adv.clamp(-1, 1)
    assert torch.equal(pu.pgd_update_kernel(adv, grad, img, 0.01, 0.03),
                       pu.pgd_update_plain(adv, grad, img, 0.01, 0.03))
    xa, xb = adv.clone(), adv.clone()
    sa, sb = au.adam_init(xa), au.adam_init(xb)
    bc1, bc2 = au.bias_corrections(1)
    au.adam_update_kernel(xa, grad, sa["mu"], sa["nu"], 1e-2, bc1, bc2)
    au.adam_update_plain(xb, grad, sb["mu"], sb["nu"], 1e-2, bc1, bc2)
    assert torch.equal(xa, xb)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0

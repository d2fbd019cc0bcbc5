"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. A CUDA kernel has no interpret mode, so these tests need an
NVIDIA GPU (marker ``cuda``) and skip without one; run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

``chip_smoke.py`` holds the same kernels at the main path's full shapes.
Tolerances: float32 (TF32 off) 1e-4 of max(1, max|plain|); bfloat16 3e-2;
pgd_update bit-exact in both (it repeats the plain float32 arithmetic);
fused_adam bit-exact in float32 (it rounds after every operation, as its
plain version does).
"""

import math

import pytest
import torch

from tpufusion_torch.ops import adam_update as au
from tpufusion_torch.ops import conv3x3 as c3
from tpufusion_torch.ops import pgd_update as pu
from tpufusion_torch.ops import styled_conv as sc

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cudnn.allow_tf32 = prev


def _close(got, want, dtype, tol=None):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    tol = TOL[dtype] if tol is None else tol
    assert err <= tol * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,res,cin,cout", [(1, 4, 512, 512), (2, 13, 64, 32),
                                            (2, 40, 32, 64)])
def test_styled_conv_kernel(cuda, dtype, n, res, cin, cout):
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda")  # noqa: E731
    args = (rn(n, res, res, cin).to(dtype), rn(3, 3, cin, cout), rn(n, cin) * 0.5 + 1,
            rn(1, res, res, 1), torch.tensor(0.2, device="cuda"), rn(cout) * 0.1)
    _close(sc.styled_conv_kernel(*args), sc.styled_conv_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c", [(1, 33, 70, 32), (2, 16, 9, 64)])
def test_conv3x3_kernels(cuda, dtype, n, h, w, c):
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").to(dtype)  # noqa: E731
    x, g = rn(n, h, w, c), rn(n, h, w, c)
    wt = (rn(3, 3, c, c).float() / math.sqrt(9 * c)).to(dtype)
    _close(c3.conv3x3_forward_kernel(x, wt), c3.conv3x3_plain(x, wt), dtype)
    _close(c3.conv3x3_input_grad_kernel(g, wt), c3.conv3x3_input_grad_plain(g, wt), dtype)
    _close(c3.conv3x3_weight_grad_kernel(x, g), c3.conv3x3_weight_grad_plain(x, g), dtype)


def test_conv3x3_autograd_counts_launches(cuda):
    x = torch.randn(1, 16, 16, 32, device="cuda", requires_grad=True)
    w = torch.randn(3, 3, 32, 32, device="cuda", requires_grad=True)
    before = (c3.conv3x3.launches_fwd, c3.conv3x3.launches_dgrad, c3.conv3x3.launches_wgrad)
    dx, dw = torch.autograd.grad(c3.conv3x3(x, w).square().sum(), (x, w))
    after = (c3.conv3x3.launches_fwd, c3.conv3x3.launches_dgrad, c3.conv3x3.launches_wgrad)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    dxr, dwr = torch.autograd.grad(c3.conv3x3_plain(xr, wr).square().sum(), (xr, wr))
    _close(dx, dxr, torch.float32)
    _close(dw, dwr, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("numel_shape", [(2, 64, 64, 3), (1, 7, 11, 3)])
def test_pgd_update_kernel(cuda, dtype, numel_shape):
    rn = lambda: torch.randn(numel_shape, generator=cuda, device="cuda").to(dtype)  # noqa: E731
    adv, g = rn().clamp(-1, 1), rn()
    img = (adv.float() + 0.01).clamp(-1, 1).to(dtype)
    args = (adv, g, img, 0.02, 16 / 255, -1.0, 1.0)
    _close(pu.pgd_update_kernel(*args), pu.pgd_update_plain(*args), dtype, tol=0.0)
    # an unaligned view takes the scalar path
    flat = [t.reshape(-1)[1:] for t in (adv, g, img)]
    _close(pu.pgd_update_kernel(*flat, *args[3:]), pu.pgd_update_plain(*flat, *args[3:]),
           dtype, tol=0.0)


@pytest.mark.parametrize("count", [1, 50])
@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (3, 37, 53, 3)])
def test_fused_adam_kernel(cuda, shape, count):
    rn = lambda: torch.randn(shape, generator=cuda, device="cuda")  # noqa: E731
    x, g, mu, nu = rn(), rn(), rn() * 0.1, rn().square() * 0.01
    bc1, bc2 = au.bias_corrections(count)
    want = au.adam_update_plain(x.clone(), g, mu.clone(), nu.clone(), 1e-2, bc1, bc2)
    got = (x.clone(), g, mu.clone(), nu.clone())
    au.adam_update_kernel(*got, 1e-2, bc1, bc2)
    for a, b in zip((got[0], got[2], got[3]), want):
        _close(a, b, torch.float32, tol=0.0)
    # views 4 bytes off 16-byte alignment take the scalar path
    off = [torch.empty(t.numel() + 1, device="cuda")[1:].copy_(t.reshape(-1))
           for t in (x, g, mu, nu)]
    want = au.adam_update_plain(*[t.clone() for t in off], 1e-2, bc1, bc2)
    au.adam_update_kernel(*off, 1e-2, bc1, bc2)
    for a, b in zip((off[0], off[2], off[3]), want):
        _close(a, b, torch.float32, tol=0.0)


def test_fused_adam_counts_launches(cuda):
    x = torch.randn(1, 8, 8, 3, device="cuda")
    st = au.adam_init(x)
    before = au.fused_adam.launches
    x2, st = au.fused_adam(x, torch.randn_like(x), st, 1e-2)
    assert x2 is x and st["count"] == 1 and au.fused_adam.launches == before + 1
    with pytest.raises(TypeError):
        au.fused_adam(x.bfloat16(), x.bfloat16(), au.adam_init(x.bfloat16()), 1e-2)

"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. A CUDA kernel has no interpret mode, so these tests need an
NVIDIA GPU (marker ``cuda``) and skip without one; run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

``chip_smoke.py`` holds the same kernels at the main path's full shapes.
Tolerances: float32 (TF32 off) 1e-4 of max(1, max|plain|); bfloat16 3e-2,
but the conv3x3 weight grad 1e-3 (``WGRAD_TOL``);
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
# The weight grad returns float32 sums and rounds nothing to bf16: a product
# of two bf16 values is exact in float32, so the kernel and its plain twin add
# the same exact terms and differ only by the order of the float32 sums, a few
# 1e-6 of the largest entry. The shared bf16 bound would pass a kernel that
# drops a halo row or column (one row of a 1024^2 plane is 1e-3 of the terms).
WGRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


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


def _styled_args(gen, dtype, n, h, w, cin, cout):
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    return (rn(n, h, w, cin).to(dtype), rn(3, 3, cin, cout), rn(n, cin) * 0.5 + 1,
            rn(1, h, w, 1), torch.tensor(0.2, device="cuda"), rn(cout) * 0.1)


# the bf16 kernel's tile classes (ops/conv3x3.py::mma_class) and the edges
# of their tiles and TMA boxes: Narrow32 / Narrow64 (Cout 32/64, resident
# weights), Wide and Mid (Cout % 128 / % 64 with enough blocks), Small (the
# rest); Cin 48 leaves a partial channel chunk (two resident chunks of
# Narrow32, 48 of Narrow64's 64), Cout 96 three Small slices, 3 x 37,
# 70 x 90, 30 x 20, 5 x 9 planes partial tiles, planes of 1-3 pixels a side
# boxes mostly outside the tensor, batch 3 at 4^2 many tiles of a few
# pixels; two launches give the same bits
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 4, 4, 512, 512), (2, 13, 13, 64, 32), (2, 40, 40, 32, 64), (2, 16, 16, 48, 64),
    (2, 16, 16, 32, 96), (1, 3, 37, 64, 64), (3, 4, 4, 512, 512), (3, 70, 90, 128, 256),
    (1, 9, 21, 48, 128), (4, 30, 20, 48, 192), (1, 1, 1, 32, 32), (2, 2, 3, 48, 64),
    (1, 33, 17, 48, 32), (2, 5, 9, 512, 512), (30, 50, 2, 128, 128), (5, 3, 1, 512, 512)])
def test_styled_conv_kernel(cuda, dtype, n, h, w, cin, cout):
    args = _styled_args(cuda, dtype, n, h, w, cin, cout)
    y = sc.styled_conv_kernel(*args)
    _close(y, sc.styled_conv_plain(*args), dtype)
    assert torch.equal(y, sc.styled_conv_kernel(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_styled_conv_kernel_takes_a_permuted_weight(cuda, dtype):
    """A module keeps its weight in its own layout: an HWIO view of an OIHW
    tensor (not contiguous) is read as HWIO. (sigma's float32 sum over the
    taps runs in the view's order, so its last bits may differ from the
    contiguous weight's: the two outputs agree to the tolerance.)"""
    x, w, s, noise, ns, b = _styled_args(cuda, dtype, 2, 12, 10, 64, 32)
    w_view = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    assert not w_view.is_contiguous() and torch.equal(w_view, w)
    y = sc.styled_conv_kernel(x, w_view, s, noise, ns, b)
    _close(y, sc.styled_conv_plain(x, w, s, noise, ns, b), dtype)
    _close(y, sc.styled_conv_kernel(x, w, s, noise, ns, b), dtype)
    assert torch.equal(y, sc.styled_conv_kernel(x, w_view, s, noise, ns, b))


def test_styled_conv_bf16_autograd(cuda):
    """bf16 on the card: the forward is the kernel, the gradients those of
    ``styled_conv_reference`` (the backward recomputes it)."""
    x, w, s, noise, ns, b = _styled_args(cuda, torch.bfloat16, 2, 24, 20, 64, 64)
    ins = [t.clone().requires_grad_(True) for t in (x, w, s, b)]
    before = sc.styled_conv.launches
    y = sc.styled_conv(ins[0], ins[1], ins[2], noise, ns, ins[3])
    assert sc.styled_conv.launches == before + 1
    g = torch.randn(y.shape, generator=cuda, device="cuda").to(y.dtype)
    grads = torch.autograd.grad(y, ins, g)
    refs = [t.clone().requires_grad_(True) for t in (x, w, s, b)]
    y_ref = sc.styled_conv_reference(refs[0], refs[1], refs[2], noise, ns, refs[3])
    _close(y, y_ref, torch.bfloat16)
    for got, want in zip(grads, torch.autograd.grad(y_ref, refs, g)):
        _close(got, want, torch.bfloat16)


# partial tiles of both Narrow classes and planes of 1-3 pixels a side;
# two launches give the same bits
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c", [(1, 33, 70, 32), (2, 16, 9, 64), (3, 1, 2, 32),
                                     (2, 3, 1, 64), (1, 130, 257, 64)])
def test_conv3x3_kernels(cuda, dtype, n, h, w, c):
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").to(dtype)  # noqa: E731
    x, g = rn(n, h, w, c), rn(n, h, w, c)
    wt = (rn(3, 3, c, c).float() / math.sqrt(9 * c)).to(dtype)
    y = c3.conv3x3_forward_kernel(x, wt)
    _close(y, c3.conv3x3_plain(x, wt), dtype)
    assert torch.equal(y, c3.conv3x3_forward_kernel(x, wt))
    dx = c3.conv3x3_input_grad_kernel(g, wt)
    _close(dx, c3.conv3x3_input_grad_plain(g, wt), dtype)
    assert torch.equal(dx, c3.conv3x3_input_grad_kernel(g, wt))
    _close(c3.conv3x3_weight_grad_kernel(x, g), c3.conv3x3_weight_grad_plain(x, g), dtype,
           tol=WGRAD_TOL[dtype])


# tiny and ragged planes, where the zero border and the partial tiles are a
# large share of the sum: a single pixel (8 of 9 taps read only padding), a
# plane narrower than a k-step, rows and columns one past a tile, several
# samples, and one plane wide enough for every block to take a few tiles
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c", [
    (1, 1, 1, 32), (1, 1, 1, 64), (1, 3, 37, 64), (2, 17, 16, 32), (3, 37, 53, 64),
    (1, 16, 33, 32), (2, 5, 2, 64), (3, 130, 257, 32), (2, 200, 180, 64)])
def test_conv3x3_weight_grad_kernel(cuda, dtype, n, h, w, c):
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").to(dtype)  # noqa: E731
    x, g = rn(n, h, w, c), rn(n, h, w, c)
    dw = c3.conv3x3_weight_grad_kernel(x, g)
    assert dw.dtype == torch.float32 and tuple(dw.shape) == (3, 3, c, c)
    _close(dw, c3.conv3x3_weight_grad_plain(x, g), dtype, tol=WGRAD_TOL[dtype])
    # no atomics, a fixed order of sums: the same bits on every launch
    assert torch.equal(dw, c3.conv3x3_weight_grad_kernel(x, g))


def test_conv3x3_weight_grad_takes_offset_views(cuda):
    """bf16 x and g at an odd storage offset are copied to aligned buffers
    (the kernel stages them with 16-byte copies)."""
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").bfloat16()  # noqa: E731
    x, g = _offset_view(rn(2, 16, 9, 64)), _offset_view(rn(2, 16, 9, 64))
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    _close(c3.conv3x3_weight_grad_kernel(x, g), c3.conv3x3_weight_grad_plain(x, g),
           torch.bfloat16, tol=WGRAD_TOL[torch.bfloat16])


def _offset_view(t):
    """A contiguous copy of ``t`` that starts one element past an aligned
    allocation (2 or 4 bytes off a 16-byte boundary)."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].copy_(
        t.reshape(-1)).view(t.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_take_offset_views(cuda, dtype):
    """Inputs at an odd storage offset (a slice, or a gradient view that
    ``contiguous()`` keeps) run and agree with the plain versions: the bf16
    route copies them to an aligned buffer first, the fp32 one reads them
    in place."""
    rn = lambda *s: torch.randn(s, generator=cuda, device="cuda").to(dtype)  # noqa: E731
    x, g = _offset_view(rn(2, 16, 9, 64)), _offset_view(rn(2, 16, 9, 64))
    wt = _offset_view((rn(3, 3, 64, 64).float() / 24).to(dtype))
    assert x.data_ptr() % 16 and g.data_ptr() % 16 and wt.data_ptr() % 16
    _close(c3.conv3x3_forward_kernel(x, wt), c3.conv3x3_plain(x, wt), dtype)
    _close(c3.conv3x3_input_grad_kernel(g, wt), c3.conv3x3_input_grad_plain(g, wt), dtype)
    args = list(_styled_args(cuda, dtype, 2, 12, 10, 32, 64))
    args[0], args[2], args[5] = (_offset_view(args[i]) for i in (0, 2, 5))
    _close(sc.styled_conv_kernel(*args), sc.styled_conv_plain(*args), dtype)
    xg = x.detach().requires_grad_(True)
    (dx,) = torch.autograd.grad(c3.conv3x3(xg, wt), xg, g)
    _close(dx, c3.conv3x3_input_grad_plain(g, wt), dtype)


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
    # views off a 16-byte boundary: all by the same offset (a scalar head,
    # then the body streams), and one alone (scalar throughout)
    flat = [t.reshape(-1)[1:] for t in (adv, g, img)]
    _close(pu.pgd_update_kernel(*flat, *args[3:]), pu.pgd_update_plain(*flat, *args[3:]),
           dtype, tol=0.0)
    mixed = [flat[0], g.reshape(-1)[:-1], flat[2]]
    _close(pu.pgd_update_kernel(*mixed, *args[3:]), pu.pgd_update_plain(*mixed, *args[3:]),
           dtype, tol=0.0)


@pytest.mark.parametrize("count", [1, 50])
@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (3, 37, 53, 3)])
def test_fused_adam_kernel(cuda, shape, count):
    rn = lambda: torch.randn(shape, generator=cuda, device="cuda")  # noqa: E731
    x, g, mu, nu = rn(), rn(), rn() * 0.1, rn().square() * 0.01
    bc1, bc2 = au.bias_corrections(count)
    table, step = au.bias_table("cuda"), au.step_index("cuda", count - 1)
    want = au.adam_update_plain(x.clone(), g, mu.clone(), nu.clone(), 1e-2, bc1, bc2)
    got = (x.clone(), g, mu.clone(), nu.clone())
    au.adam_update_kernel(*got, 1e-2, table, step)
    for a, b in zip((got[0], got[2], got[3]), want):
        _close(a, b, torch.float32, tol=0.0)
    # views 4 bytes off 16-byte alignment (a scalar head, then the body
    # streams), and g alone off (scalar throughout)
    off = [torch.empty(t.numel() + 1, device="cuda")[1:].copy_(t.reshape(-1))
           for t in (x, g, mu, nu)]
    for views in (off, [t.reshape(-1).clone() if i != 1 else o
                        for i, (t, o) in enumerate(zip((x, g, mu, nu), off))]):
        want = au.adam_update_plain(*[t.clone() for t in views], 1e-2, bc1, bc2)
        au.adam_update_kernel(*views, 1e-2, table, step)
        for a, b in zip((views[0], views[2], views[3]), want):
            _close(a, b, torch.float32, tol=0.0)


def test_fused_adam_counts_launches(cuda):
    x = torch.randn(1, 8, 8, 3, device="cuda")
    st = au.adam_init(x)
    before = au.fused_adam.launches
    x2, st = au.fused_adam(x, torch.randn_like(x), st, 1e-2)
    assert x2 is x and st["count"] == 1 and au.fused_adam.launches == before + 1
    with pytest.raises(TypeError):
        au.fused_adam(x.bfloat16(), x.bfloat16(), au.adam_init(x.bfloat16()), 1e-2)


def test_fused_adam_device_count_over_steps(cuda):
    """A device step count (``adam_init(on_device=True)``): the kernel reads
    row ``count`` of the bias table, then the count advances in place; bit
    for bit the plain twin with the host's corrections, steps 1..n."""
    shape = (2, 33, 17, 3)
    x0 = torch.randn(shape, generator=cuda, device="cuda")
    xa, xb = x0.clone(), x0.clone()
    sa, sb = au.adam_init(xa, on_device=True), au.adam_init(xb)
    for t in range(1, 8):
        g = torch.randn(shape, generator=cuda, device="cuda")
        au.fused_adam(xa, g, sa, 1e-2)
        au.adam_update_plain(xb, g, sb["mu"], sb["nu"], 1e-2, *au.bias_corrections(t))
        for a, b in ((xa, xb), (sa["mu"], sb["mu"]), (sa["nu"], sb["nu"])):
            _close(a, b, torch.float32, tol=0.0)
    assert int(sa["count"]) == 7


# the attack loops' CUDA graphs (``core/graphs.py``) against the eager twins


@pytest.fixture
def deterministic(cuda):
    import os

    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield cuda
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = flag
    if env is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def _tree_equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_tree_equal(u, v) for u, v in zip(a, b))
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.fixture
def small_pipeline(deterministic):
    from tpufusion_torch.pipeline import create_test_pipeline

    return create_test_pipeline("ffhq", device="cuda")


def test_pgd_graph_equals_the_eager_loop(small_pipeline):
    import dataclasses

    from tpufusion_torch import ops
    from tpufusion_torch.attacks.fusion_attack import (
        FusionAttackConfig, make_fusion_attack, make_fusion_loss)
    from tpufusion_torch.attacks.pgd import pgd_eager, pgd_random_start

    p = small_pipeline
    g = torch.Generator(device="cuda").manual_seed(1)
    s = p.image_size
    x = torch.rand((2, s, s, 3), generator=g, device="cuda") * 2 - 1
    t = torch.rand((1, s, s, 3), generator=g, device="cuda") * 2 - 1
    cfg = FusionAttackConfig(pgd=dataclasses.replace(FusionAttackConfig().pgd, steps=3))
    attack = make_fusion_attack(p, cfg)
    got = attack(x, t, torch.Generator(device="cuda").manual_seed(2))
    (prog,) = list(attack.programs)
    assert prog.graph is not None and prog.launches["pgd_update"] == 1
    pc = dataclasses.replace(cfg.pgd, targeted=True)
    start = pgd_random_start(x, torch.Generator(device="cuda").manual_seed(2), pc)
    ops.reset_launch_counts()
    want = pgd_eager(make_fusion_loss(p, cfg), pc, x, start, t)
    eager = ops.launch_counts()
    assert _tree_equal(got, want)
    # a second call replays: the counts read per step as the eager loop's
    ops.reset_launch_counts()
    again = attack(x, t, torch.Generator(device="cuda").manual_seed(2))
    assert ops.launch_counts() == eager and _tree_equal(again, want)
    attack.programs.release()


def test_whitebox_graph_equals_the_eager_loop(small_pipeline):
    from tpufusion_torch.attacks import whitebox as wb

    p = small_pipeline
    g = torch.Generator(device="cuda").manual_seed(3)
    s = p.image_size
    x = torch.rand((3, s, s, 3), generator=g, device="cuda") * 2 - 1
    t = torch.rand((1, s, s, 3), generator=g, device="cuda") * 2 - 1
    for kw in (dict(), dict(grad_accum=2, snapshot_every=2, execution="stepwise")):
        cfg = wb.WhiteboxConfig(lr=1e-2, n_iters=5, **kw)
        got = wb.make_per_image_whitebox(p, cfg)(x, t)
        assert _tree_equal(got, wb.run_eager(p, cfg, x, t, per_image=True)), kw


def test_cw_graph_equals_the_eager_loop(deterministic):
    from tpufusion_torch.attacks.cw import CWConfig, cw_eager, make_cw
    from tpufusion_torch.models import classifiers as tc
    from tpufusion_torch.models.resnet import ResNet

    model = ResNet(2, width=8, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(4))
    model.requires_grad_(False)
    fn = tc.resnet_logits_fn(32)
    x = torch.rand((4, 48, 48, 3), generator=deterministic, device="cuda") * 1.6 - 0.8
    with torch.no_grad():
        labels = fn(model, x).argmax(-1)
    cfg = CWConfig(c=100.0, steps=10)
    got = make_cw(lambda im, m: fn(m, im), cfg)(x, labels, model)
    want = cw_eager(lambda im, m: fn(m, im), cfg, x, labels, model)
    assert (got[0] - want[0]).abs().max().item() <= 1e-6
    assert torch.equal(torch.isfinite(got[1]), torch.isfinite(want[1]))


def test_resize_gradient_is_deterministic_on_the_card(deterministic):
    """The classifiers' antialiased resize at the FFHQ attack's shape
    (5 x 1024^2 -> 256^2): its backward warns of no atomics, gives the same
    bits twice, and agrees with PyTorch's own backward (1e-6 of the largest
    entry, float32 sums in another order)."""
    import warnings

    import torch.nn.functional as F

    from tpufusion_torch.core.imaging import resize_bilinear

    x = torch.rand((5, 1024, 1024, 3), generator=deterministic, device="cuda") * 2 - 1
    g = torch.randn((5, 256, 256, 3), generator=deterministic, device="cuda")

    def grad():
        xt = x.clone().requires_grad_()
        (resize_bilinear(xt, 256, 256) * g).sum().backward()
        return xt.grad

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*deterministic")
        first = grad()
        assert torch.equal(first, grad())
    torch.use_deterministic_algorithms(False)
    xp = x.clone().requires_grad_()
    y = F.interpolate(xp.permute(0, 3, 1, 2), size=(256, 256), mode="bilinear",
                      align_corners=False, antialias=True)
    (y.permute(0, 2, 3, 1) * g).sum().backward()
    err = (first - xp.grad).abs().max().item()
    assert err <= 1e-6 * xp.grad.abs().max().item(), err


def test_a_body_that_reads_the_device_raises_at_capture(cuda):
    from tpufusion_torch.core.graphs import WARMUP, StepProgram

    calls = []

    def body(state, inputs):
        calls.append(1)
        state["x"].add_(state["x"].sum().item())

    x = torch.ones(4, device="cuda")
    prog = StepProgram(body, dict(x=x), {}, limit=WARMUP + 2)
    with pytest.raises(Exception):
        prog.run(WARMUP + 2)
    # the warm-up steps and the failed capture, and no eager run after it
    assert len(calls) == WARMUP + 1 and prog.graph is None
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full((4,), 5.0 ** WARMUP, device="cuda"))

"""The port's sharded checkpoint (``io/dcp_io.py``,
``io/attack_state.py::run_whitebox_sharded_resumable``), its serving
programs (``io/export.py``, ``cli/export_programs.py``) and the
``tpufusion::styled_conv`` operator they export, on the CPU at 32^2, one
process (a one-rank gloo group; the two-rank DCP resume is in
``tests/test_torch_parallel.py``).

- DCP: a nest of DTensors, plain tensors, lists and scalars saved and
  restored onto a template equals what was saved; a checkpoint that does
  not fit the template raises, and the resumable white-box run refuses to
  restart over checkpoints it cannot restore;
- export: ``export_decode`` and ``export_spatial_fusion`` at 32^2, saved,
  loaded and run, equal the eager forwards bit for bit (the same CPU ops),
  hold the ``tpufusion::styled_conv`` node, and keep the weights out of the
  artifact (parameters are arguments); the ``.roles`` file is JAX's;
- ``export_programs --tiny``: a serving process's view, ``load_program`` +
  ``load_pytree`` and no model code, decodes as the live generator;
- ``torch.library.opcheck`` of the operator on the CPU, its backward equal
  to autograd of the composite, and its fake shape; the same of the up
  operator ``tpufusion::styled_conv_up`` in bf16, and a bf16 synthesis
  exported with one node per styled conv of either kind.
"""

import os

import numpy as np
import pytest
import torch

from tpufusion_torch import parallel as P
from tpufusion_torch.io import dcp_io
from tpufusion_torch.io.export import (
    export_decode,
    export_spatial_fusion,
    load_program,
    module_params,
    spatial_roles,
)
from tpufusion_torch.ops import styled_conv as sc
from tpufusion_torch.pipeline import create_test_pipeline

S = 32


@pytest.fixture(scope="module", autouse=True)
def no_process_group_left():
    """The one-rank groups that meshes start here end with the module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipe():
    return create_test_pipeline("ffhq", device="cpu", seed=4)


def test_dcp_round_trip_onto_a_template(tmp_path):
    from torch.distributed.tensor import DTensor

    mesh = P.create_mesh("cpu")
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(4, 3, generator=g)
    tree = dict(x=P.sharding.as_dtensors(mesh, rows), feats=[torch.randn(2, 5, generator=g),
                torch.arange(6).reshape(2, 3)], count=7, lr=0.5)
    path = dcp_io.save_checkpoint(str(tmp_path / "ck"), tree)
    assert os.path.exists(os.path.join(path, ".metadata"))
    template = dict(x=P.sharding.as_dtensors(mesh, torch.zeros(4, 3)),
                    feats=[torch.zeros(2, 5), torch.zeros(2, 3, dtype=torch.long)],
                    count=0, lr=0.0)
    got = dcp_io.restore_checkpoint(path, template)
    assert isinstance(got["x"], DTensor) and got["x"].placements == tree["x"].placements
    assert torch.equal(got["x"].to_local(), rows)
    assert all(torch.equal(a, b) for a, b in zip(got["feats"], tree["feats"]))
    assert got["count"] == 7 and got["lr"] == 0.5
    # the template's tensors are filled in place
    assert got["feats"][0] is template["feats"][0]
    with pytest.raises(RuntimeError, match="Size mismatch"):
        dcp_io.restore_checkpoint(path, dict(template, x=P.sharding.as_dtensors(
            mesh, torch.zeros(5, 3))))


def test_resumable_whitebox_refuses_unrestorable_checkpoints(pipe, tmp_path):
    from tpufusion_torch.attacks.whitebox import WhiteboxConfig
    from tpufusion_torch.io.attack_state import run_whitebox_sharded_resumable

    mesh = P.create_mesh("cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, S, S, 3, generator=g) * 2 - 1
    t = torch.rand(1, S, S, 3, generator=g) * 2 - 1
    ckpt = str(tmp_path / "ck")
    cfg = WhiteboxConfig(n_iters=1, lr=1e-2)
    adv, trace, start = run_whitebox_sharded_resumable(pipe, x, t, cfg, None, mesh, ckpt,
                                                       checkpoint_every=1)
    assert start == 0 and tuple(trace.shape) == (2, 1) and os.listdir(ckpt) == ["step_1"]
    # all done: a second call runs nothing and returns the restored pixels
    adv2, trace2, start2 = run_whitebox_sharded_resumable(pipe, x, t, cfg, None, mesh, ckpt)
    assert start2 == 1 and trace2 is None and torch.equal(adv2, adv)
    # another batch does not fit the saved state: refuse, keep the files
    with pytest.raises(RuntimeError, match="refusing to restart from 0"):
        run_whitebox_sharded_resumable(pipe, torch.cat([x, x]), t, cfg, None, mesh, ckpt)
    assert os.listdir(ckpt) == ["step_1"]


@pytest.fixture(scope="module")
def exported(pipe, tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    dec = export_decode(pipe, str(d / "decode.pt2"), batch=2)
    fus = export_spatial_fusion(pipe.drawer, str(d / "fusion.pt2"))
    return dec, fus


def _has_styled_conv_node(program):
    return any("tpufusion.styled_conv" in str(n.target)
               for n in program.exported.graph.nodes if n.op == "call_function")


def test_exported_decode_equals_the_eager_forward(pipe, exported):
    dec_path, _ = exported
    dec = load_program(dec_path)
    codes = torch.randn(2, pipe.generator.n_latent, 512, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = pipe.decode(codes)
    got = dec(module_params(pipe.generator), codes)
    assert torch.equal(got, want)
    assert _has_styled_conv_node(dec)
    assert dec.in_avals[-1] == ((2, pipe.generator.n_latent, 512), torch.float32)
    assert dec.platforms == ["cpu"]
    # the weights are arguments, not in the artifact
    n_bytes = sum(v.numel() * 4 for v in module_params(pipe.generator).values())
    assert os.path.getsize(dec_path) < n_bytes / 20


def test_exported_spatial_fusion_equals_the_eager_forward(pipe, exported):
    from tpufusion_torch.fusion.spatial import ROLE_MAPS, spatial_fused

    _, fus_path = exported
    fus = load_program(fus_path)
    lat = torch.randn(1, 5, pipe.generator.n_latent, 512,
                      generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _ = spatial_fused(pipe.drawer, lat)
    by_role = {r: lat[:, i] for i, r in enumerate(ROLE_MAPS["ffhq"]["roles"])}
    base, swaps = spatial_roles("ffhq")
    got = fus(module_params(pipe.generator), module_params(pipe.drawer.blender),
              pipe.drawer.mean_latent, by_role[base], *[by_role[r] for _, r in swaps])
    assert torch.equal(got, want)
    assert _has_styled_conv_node(fus)
    with open(fus_path + ".roles") as f:
        roles = f.read()
    assert roles == "base=global\nhair=hair\nbackground=background\nmouth=mouth\neyes=eyes\n"


def test_spatial_roles_match_jax_export():
    from tpufusion.fusion.drawer import SWAP_TABLE
    from tpufusion.fusion.spatial import ROLE_MAPS

    for dataset in ("ffhq", "car", "church"):
        cfg = ROLE_MAPS[dataset]
        provided = tuple(k for k, _ in SWAP_TABLE if k in cfg["kwargs"])
        base, swaps = spatial_roles(dataset)
        assert base == cfg["base"]
        assert swaps == [(k, cfg["kwargs"][k]) for k in provided]


def test_export_programs_cli_serves_without_model_code(tmp_path):
    from tpufusion_torch.cli import export_programs
    from tpufusion_torch.io.params_io import load_pytree

    out = tmp_path / "art"
    assert export_programs.main(["--dataset", "church", "--tiny", "--size", "32",
                                 "--device", "cpu", "--batch", "1", "--out", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["decode.pt2", "fusion.pt2", "fusion.pt2.roles",
                                       "params.npz"]
    # the serving side: the artifact and the weights, no model building
    params = load_pytree(str(out / "params.npz"))
    gen = {k: torch.from_numpy(v) for k, v in params["gen_params"].items()}
    live = create_test_pipeline("church", size=32, device="cpu")
    codes = torch.randn(1, live.generator.n_latent, 512,
                        generator=torch.Generator().manual_seed(5))
    got = load_program(str(out / "decode.pt2"))(gen, codes)
    with torch.no_grad():
        want = live.decode(codes)
    assert torch.equal(got, want)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 64), (1, 4, 4, 64, 32), (3, 5, 7, 16, 32)])
def test_styled_conv_operator_opcheck(shape):
    n, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(6)
    args = [torch.randn(n, h, w, cin, generator=g), torch.randn(3, 3, cin, cout, generator=g),
            torch.randn(n, cin, generator=g) * 0.5 + 1, torch.randn(1, h, w, 1, generator=g),
            torch.tensor(0.2), torch.randn(cout, generator=g) * 0.1]
    torch.library.opcheck(sc.styled_conv_op, args)
    want = sc.styled_conv_reference(*args)
    assert torch.equal(sc.styled_conv(*args), want)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = sc.styled_conv_op(*[mode.from_tensor(a) for a in args])
    assert tuple(fake.shape) == (n, h, w, cout) and fake.dtype == want.dtype
    # the backward is autograd of the composite
    xs = [a.clone().requires_grad_(True) for a in args[:3]]
    (gx, gw, gs) = torch.autograd.grad(sc.styled_conv(*xs, *args[3:]).square().sum(), xs)
    ys = [a.clone().requires_grad_(True) for a in args[:3]]
    (hx, hw, hs) = torch.autograd.grad(sc.styled_conv_reference(*ys, *args[3:]).square().sum(),
                                       ys)
    for a, b in ((gx, hx), (gw, hw), (gs, hs)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 4, 4, 32, 32), (1, 5, 3, 16, 24), (2, 8, 8, 64, 32)])
def test_styled_conv_up_operator_opcheck(shape):
    """``tpufusion::styled_conv_up`` on the CPU (bf16, the shapes it takes):
    opcheck, the folded composite's bits, the fake's shape and dtype, and
    the backward as autograd of the composite."""
    n, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(7)
    args = [torch.randn(n, h, w, cin, generator=g).bfloat16(),
            torch.randn(3, 3, cin, cout, generator=g),
            torch.randn(n, cin, generator=g) * 0.5 + 1,
            torch.randn(1, 2 * h, 2 * w, 1, generator=g), torch.tensor(0.2),
            torch.randn(cout, generator=g) * 0.1]
    assert sc.up_supported(args[0].shape, args[1].shape, args[3].shape, args[0].dtype)
    torch.library.opcheck(sc.styled_conv_up_op, args)
    want = sc.styled_conv_up_reference(*args)
    assert torch.equal(sc.styled_conv_up(*args), want)
    assert tuple(want.shape) == (n, 2 * h, 2 * w, cout) and want.dtype == torch.bfloat16
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = sc.styled_conv_up_op(*[mode.from_tensor(a) for a in args])
    assert tuple(fake.shape) == tuple(want.shape) and fake.dtype == want.dtype
    xs = [args[0].clone().requires_grad_(True), args[2].clone().requires_grad_(True)]
    (gx, gs) = torch.autograd.grad(
        sc.styled_conv_up(xs[0], args[1], xs[1], *args[3:]).float().square().sum(), xs)
    ys = [args[0].clone().requires_grad_(True), args[2].clone().requires_grad_(True)]
    (hx, hs) = torch.autograd.grad(
        sc.styled_conv_up_reference(ys[0], args[1], ys[1], *args[3:]).float().square().sum(),
        ys)
    assert torch.equal(gx, hx) and torch.equal(gs, hs)


def test_exported_bf16_decode_has_a_node_per_styled_conv(tmp_path):
    """A bf16 32^2 synthesis exports with one ``tpufusion::styled_conv``
    node per non-upsampling styled conv and one ``tpufusion::styled_conv_up``
    node per up conv (log2(size) - 2), and the loaded program decodes as
    the eager forward."""
    from tpufusion_torch.core.dtypes import Policy
    from tpufusion_torch.models.stylegan2 import Generator

    gen = Generator(32, channel_multiplier=1, policy=Policy(compute_dtype=torch.bfloat16),
                    device="cpu", generator=torch.Generator().manual_seed(8)).requires_grad_(False)
    pipe = type("P", (), {"generator": gen})()
    dec = load_program(export_decode(pipe, str(tmp_path / "decode.pt2")))
    targets = [str(n.target) for n in dec.exported.graph.nodes if n.op == "call_function"]
    assert sum("tpufusion.styled_conv_up" in t for t in targets) == 3
    assert sum("tpufusion.styled_conv." in t for t in targets) == 4
    codes = torch.randn(1, gen.n_latent, 512, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        want = gen([codes], input_is_latent=True).image
    assert torch.equal(dec(module_params(gen), codes), want)

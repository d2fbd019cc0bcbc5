"""The reference against the port at 32^2 on the CPU, on one state dict.

The benchmark's state dicts load into the reference models and, with
``load_state_dict``, into the port's (whose CPU path is its plain twins);
both compute in float32 and must agree to float32 rounding. Then each cell
runs end to end through the harness at the small sizes: the port's answer
and the reference's agree, so every compared number reads ~0.
"""

import math

import pytest
import torch

from portbench import harness, program, weights
from portbench.reference import models as ref
from portbench.tests import tiny

CELLS = tiny.cells()
MIXES = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json"))


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    config = {**harness.load_cell("ffhq1024.whitebox")[2], **tiny.CONFIG}
    state = weights.make_state(config, 5, "cpu")
    models = weights.reference_models(config, state)
    mean = weights.mean_latent(models["generator"], 5, 64)
    pipe = program.build_pipeline(config, state, mean, "cpu")
    return config, models, pipe


def _close(a, b, tol=2e-4):
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    assert err <= tol * max(scale, 1.0), (err, scale)


def test_generator_matches(pair):
    _, models, pipe = pair
    w = torch.randn(2, 8, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        mine = models["generator"](w)
        port = pipe.decode(w).permute(0, 3, 1, 2)
    _close(port, mine)


def test_encoder_and_taps_match(pair):
    _, models, pipe = pair
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    with torch.no_grad():
        _close(pipe.encoder(x), models["encoder"](x.permute(0, 3, 1, 2)))
        for a, b in zip(pipe.vgg(x), models["vgg16"](x.permute(0, 3, 1, 2))):
            _close(a.permute(0, 3, 1, 2), b)


def test_weights_follow_the_seed():
    config = {**harness.load_cell("ffhq1024.whitebox")[2], **tiny.CONFIG}
    a, b = weights.make_state(config, 7, "cpu"), weights.make_state(config, 7, "cpu")
    c = weights.make_state(config, 8, "cpu")
    for model in a:
        assert a[model].keys() == c[model].keys()
        for k in a[model]:
            assert torch.equal(a[model][k], b[model][k]), k
    assert not torch.equal(a["encoder"]["body.0.res_layer.1.weight"],
                           c["encoder"]["body.0.res_layer.1.weight"])


def test_modulated_conv_is_the_published_one():
    """The unfused form equals the grouped convolution of the published
    code (weights modulated and demodulated per sample)."""
    g = torch.Generator().manual_seed(3)
    conv = ref.ModulatedConv2d(16, 32, 3, 24, ref.FLOAT32)
    conv.weight.data = torch.randn(1, 32, 16, 3, 3, generator=g)
    conv.modulation.weight.data = torch.randn(16, 24, generator=g)
    x, w = torch.randn(3, 16, 8, 8, generator=g), torch.randn(3, 24, generator=g)
    style = conv.modulation(w)
    wt = conv.scale * conv.weight * style.view(3, 1, 16, 1, 1)
    wt = wt * torch.rsqrt(wt.square().sum([2, 3, 4]) + 1e-8).view(3, 32, 1, 1, 1)
    grouped = torch.nn.functional.conv2d(x.view(1, 48, 8, 8), wt.view(96, 16, 3, 3),
                                         padding=1, groups=3).view(3, 32, 8, 8)
    _close(conv(x, w), grouped, 1e-5)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_on_the_cpu(cell):
    out = tiny.run(cell)
    assert out["correct"], out["checked"]
    assert out["attempted"] == 1 and out["failed"] == 0
    for name, c in out["checked"].items():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"], (name, c)
    assert set(out["metrics"]) >= {"attack_step_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("mix_name", MIXES)
def test_reference_answer_is_the_ports(mix_name):
    """In float32 on the CPU the reference's attack and the port's give the
    same answer for the same group, to rounding (every mix, ``ffhq1024``'s
    modules at the small sizes)."""
    from portbench import traffic
    from portbench.reference import attacks

    mix = harness.read_json(harness.HERE / "traffic" / f"{mix_name}.json")
    ov = tiny.mix_overrides(mix, steps=4)
    config = {**harness.load_cell("ffhq1024.whitebox")[2], **ov["config"]}
    mix = {**mix, **ov["mix"]}
    seed = 2 ** 33 + 3
    pipe = harness.build_program(config, seed, "cpu")
    images, target, gen = traffic.group_inputs(seed, 0, 2, 32, mix["images"], "cpu")
    adv = program.dispatch(pipe, mix["attack"], images, target,
                           program.run_config(config, mix["attack"], mix["run_config"]), gen)
    models = weights.reference_models(config, weights.make_state(config, seed, "cpu"))
    mine = attacks.load(mix["attack"]).answer(models, mix,
                                              harness.reference_group(config, mix, seed, 0, "cpu"))
    assert (adv.permute(0, 3, 1, 2) - mine).abs().max().item() <= 1e-5

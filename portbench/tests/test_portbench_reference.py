"""The reference against the port at 32^2 on the CPU, on one state dict.

The benchmark's state dicts load into the reference models and, with
``load_state_dict``, into the port's (whose CPU path is its plain twins);
both compute in float32 and must agree to float32 rounding: the generator
from W+ and from style vectors, the encoder, VGG16's taps and StyleFusion's
fusion nets. Then each cell runs end to end through the harness at the
small sizes: the port's answer and the reference's agree, so every compared
number reads ~0. The models' weights, a group's inputs and the reference's
white-box answer are the ones the harness drew before the fusion nets and
the attack's generator were added to it (hashes pinned from that tree).
"""

import hashlib
import math
import sys
import types

import pytest
import torch

from portbench import harness, program, weights
from portbench.reference import models as ref
from portbench.tests import tiny

CELLS = tiny.cells()


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


def _sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# from the tree before: make_state's leaves in state-dict order, group 0's
# images and target, 64 draws of its generator, and the reference's
# white-box answer in 2 steps on one thread (seed 2**31 + 11, 32^2)
PINNED = {"generator": "a86a0fe223ac5cac", "encoder": "2a08c08eee81069f",
          "vgg16": "13559aeadece8e95", "inputs": "bbf89dae266f6938",
          "draws": "a48081473bb7939c", "answer": "b0159b101698b03f"}
FUSION_NETS = {"architecture": "StyleFusion hierarchy (arXiv:2107.06996)", "hidden": 16}


def _small(cell, steps=2):
    ov = tiny.overrides(cell, steps=steps)
    _, _, config, mix, _ = harness.load_cell(cell)
    return {**config, **ov["config"]}, {**mix, **ov["mix"]}


def test_draws_are_the_ones_before_the_fusion_nets():
    from portbench import traffic
    from portbench.reference import attacks

    seed = 2 ** 31 + 11
    config, mix = _small("ffhq1024.whitebox")
    state = weights.make_state(config, seed, "cpu")
    with_nets = weights.make_state({**config, "fusion_nets": FUSION_NETS}, seed, "cpu")
    assert set(with_nets) == set(state) | {"fusion_nets"}
    for model, sd in state.items():
        assert _sha(*sd.values()) == PINNED[model], model
        assert all(torch.equal(t, with_nets[model][k]) for k, t in sd.items()), model
    images, target, gen = traffic.group_inputs(seed, 0, 2, 32, mix["images"], "cpu")
    assert _sha(images, target) == PINNED["inputs"]
    assert _sha(torch.rand(64, generator=gen)) == PINNED["draws"]
    models = weights.reference_models(config, state)
    group = harness.reference_group(config, mix, seed, 0, "cpu", models)
    assert torch.equal(group.images, images) and torch.equal(group.target, target)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        adv = attacks.load(mix["attack"]).answer(models, mix, group)
    finally:
        torch.set_num_threads(threads)
    assert _sha(adv) == PINNED["answer"]


def test_group_draws_again_what_the_program_draws():
    """``Group.draws`` gives the generator's draws, as often as asked, and
    leaves the generator where it was."""
    from portbench import traffic

    config, mix = _small("ffhq1024.fusion_pgd_arith")
    models = weights.reference_models(config, weights.make_state(config, 3, "cpu"))
    group = harness.reference_group(config, mix, 3, 1, "cpu", models)
    gen = traffic.group_inputs(3, 1, 2, 32, mix["images"], "cpu")[2]
    first = torch.rand(group.images.shape, generator=group.draws())
    assert torch.equal(first, torch.rand(group.images.shape, generator=group.draws()))
    assert torch.equal(first, torch.rand(group.images.shape, generator=gen))
    assert torch.equal(first, torch.rand(group.images.shape, generator=group.generator))
    assert group.latent_avg.shape == (1, 128)


@pytest.fixture(scope="module")
def fusion_pair():
    """The port's pipeline and the reference models of a 32^2 config with a
    ``fusion_nets`` block, on one state dict."""
    config = {**harness.load_cell("ffhq1024.whitebox")[2], **tiny.CONFIG,
              "fusion_nets": FUSION_NETS}
    pipe = harness.build_program(config, 11, "cpu")
    models = weights.reference_models(config, weights.make_state(config, 11, "cpu"))
    return config, pipe, models


def _styles(dims, n, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(1.0 + 0.5 * torch.randn(n, d, generator=g) for d in dims)


def test_fusion_nets_match(fusion_pair):
    _, pipe, models = fusion_pair
    blender = pipe.drawer.blender
    dims = models["generator"].style_input_dims()
    assert list(blender.style_dims) == dims
    assert set(blender.state_dict()) == set(models["fusion_nets"].state_dict())
    s_dict = {part: _styles(dims, 2, k) for k, part in enumerate(pipe.drawer.parts)}
    with torch.no_grad():
        port, mine = blender(s_dict), models["fusion_nets"](s_dict)
    assert len(port) == len(mine) == len(dims)
    for a, b in zip(port, mine):
        _close(a, b, 1e-5)
    # the gates are live: no layer's blend is one child alone
    left = models["fusion_nets"](s_dict, "face")
    assert all(not torch.allclose(a, b) for a, b in zip(mine, left))


def test_generator_from_style_vectors_matches(fusion_pair):
    _, pipe, models = fusion_pair
    gen = models["generator"]
    styles = _styles(gen.style_input_dims(), 2, 99)
    with torch.no_grad():
        mine = gen.synthesis(styles)
        port = pipe.drawer.generator(style_vector=styles).image.permute(0, 3, 1, 2)
        w = torch.randn(2, gen.n_latent, 128, generator=torch.Generator().manual_seed(4))
        assert torch.equal(gen(w), gen.synthesis(gen.styles(w)))
    _close(port, mine, 1e-5)


def test_a_config_with_fusion_nets_counts_its_operations(fusion_pair):
    from portbench import flops

    config, _, _ = fusion_pair
    mix = harness.load_cell("ffhq1024.fusion_pgd_arith")[3]
    with_nets = flops.group_flops(config, mix)
    assert with_nets == flops.group_flops({k: v for k, v in config.items()
                                           if k != "fusion_nets"}, mix) > 0


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


@pytest.mark.parametrize("cell", CELLS)
def test_reference_answer_is_the_ports(cell):
    """In float32 on the CPU the reference's attack and the port's give the
    same answer for the same group, to rounding (every cell, its own
    configuration at the small sizes, with their N)."""
    from portbench import traffic
    from portbench.reference import attacks

    config, mix = _small(cell, steps=4)
    n, size = int(config["n_inputs"]), int(config["generator"]["size"])
    seed = 2 ** 33 + 3
    # four threads, as tiny.run: a signed step's pixel whose gradient is ~0
    # follows the sums' rounding, and so their split between threads
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        pipe = harness.build_program(config, seed, "cpu")
        images, target, gen = traffic.group_inputs(seed, 0, n, size, mix["images"], "cpu")
        adv = program.dispatch(pipe, mix["attack"], images, target,
                               program.run_config(config, mix["attack"], mix["run_config"]),
                               gen)
        models = weights.reference_models(config, weights.make_state(config, seed, "cpu"))
        group = harness.reference_group(config, mix, seed, 0, "cpu", models)
        mine = attacks.load(mix["attack"]).answer(models, mix, group)
    finally:
        torch.set_num_threads(threads)
    assert adv.shape[0] == n
    assert (adv.permute(0, 3, 1, 2) - mine).abs().max().item() <= 1e-5


@pytest.mark.parametrize("hook", [None, 5])
def test_small_sizes_take_the_attacks_n(hook, monkeypatch):
    """An attack whose reference module gives ``n_inputs(config)`` runs at
    that N in every small size (``tiny.overrides``, ``control_overrides``),
    with the configuration it is asked for; without the hook, at 2."""
    name = "stub_fixed_n"
    stub = types.ModuleType(f"portbench.reference.attacks.{name}")
    asked = []
    if hook is not None:
        def n_inputs(config):
            asked.append(config["dataset"])
            return hook

        stub.n_inputs = n_inputs
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    spec, cell, config, mix, limits = harness.load_cell("ffhq1024.fusion_pgd_arith")
    monkeypatch.setattr(harness, "load_cell",
                        lambda *a: (spec, cell, config, {**mix, "attack": name}, limits))
    want = 2 if hook is None else hook
    assert tiny.overrides("any")["config"]["n_inputs"] == want
    ov = tiny.control_overrides("any")
    assert ov["config"]["n_inputs"] == want
    assert ov["config"]["generator"] == tiny.CONTROL_CONFIG["generator"]  # a short-group mix
    assert tiny.mix_overrides(config, {**mix, "attack": name})["config"]["n_inputs"] == want
    assert asked == ([] if hook is None else ["ffhq"] * 3)

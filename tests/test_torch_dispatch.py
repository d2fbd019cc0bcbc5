"""The port's runner on its own 32^2 church test pipeline (N = 3), CPU,
float32 (``tpufusion_torch/runner.py``): the paths that
``tests/test_torch_runner.py``'s parity run with the JAX package does not
take.

- every entry of ``ATTACK_CHOICES`` dispatches; the random ones (the PGD
  starts, ``dp_noise``, the patch draws, CW) keep their invariants: the
  eps-ball and [-1, 1], finite pixels, the loss log's length; the white-box
  pixels move at most lr a step;
- a saved patch is reused; an unknown attack raises; a one-device mesh is
  the single-device path, and ``whitebox_grad_accum > 1`` with a
  multi-device mesh raises JAX's error; the white-box executor rules are
  JAX's;
- snapshots and ``whitebox_grad_accum`` through ``run_experiment``, R+FGSM's
  recorded semantics, the hybrid splice, realism scores, the mid-run flush
  with ``adv_override``, the transfer chain and ``generate_inputs``.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tpufusion import runner as j_runner
from tpufusion_torch import runner
from tpufusion_torch.configs import ATTACK_CHOICES, AttackRunConfig

N = 3  # the church roles
LR = 1e-4  # AttackRunConfig's white-box lr


@pytest.fixture(scope="module", autouse=True)
def no_process_group_left():
    """The one-rank groups that meshes start here end with the module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def tiny():
    """The port's own church 32^2 test pipeline, with inputs and a target."""
    from tpufusion_torch.pipeline import create_test_pipeline

    p = create_test_pipeline("church", device="cpu", seed=2)
    g = torch.Generator().manual_seed(3)
    return p, torch.rand(N, 32, 32, 3, generator=g) * 2 - 1, torch.rand(1, 32, 32, 3, generator=g) * 2 - 1


def _loss_lines(run_dir, attack):
    with open(os.path.join(run_dir, f"loss_{attack}.txt")) as f:
        return f.read().strip().splitlines()


@pytest.mark.parametrize("attack", ATTACK_CHOICES)
def test_every_registered_attack_dispatches(tiny, attack, tmp_path):
    p, inputs, target = tiny
    adv_npz = str(tmp_path / "adv.npz")
    np.savez(adv_npz, data=inputs.numpy())
    cfg = AttackRunConfig(dataset_name="church", n_iters=2, max_count=2, epochs=1,
                          pgd_steps=2, cw_steps=2, patch_size=0.2, snapshot_every=0)
    cfg.paths.adv_inputs_path = adv_npz
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    advs = runner.dispatch_attack(p, attack, inputs, target, cfg,
                                  torch.Generator().manual_seed(7), run_dir=run_dir)
    assert len(advs) == (N if attack == "out_domain_single" else 1)
    for adv in advs:
        assert adv.shape == inputs.shape and torch.isfinite(adv).all(), attack
    adv = advs[0]
    eps = cfg.pgd_eps * 2.0
    if attack not in ("dp_noise", "white_box_target", "white_box_patch"):
        # unclamped by design: the Laplace noise and the white-box Adam steps
        assert adv.min() >= -1 and adv.max() <= 1, attack
    if attack in ("pgd", "fgsm", "pgd_classifier", "fusion_pgd_arith", "fusion_pgd_spatial"):
        assert (adv - inputs).abs().max() <= eps + 1e-6, attack
        assert (adv - inputs).abs().max() > 0, attack
        assert len(_loss_lines(run_dir, attack)) == (1 if attack == "fgsm" else 2)
    if attack in ("white_box_target", "white_box_patch"):
        assert len(_loss_lines(run_dir, attack)) == N * 2
        assert (adv - inputs).abs().max() <= 2 * LR * 1.001
    if attack in ("cw", "cw_classifier"):
        assert len(_loss_lines(run_dir, attack)) == N
    if attack in ("pgd_classifier", "cw", "cw_classifier"):
        assert os.path.exists(os.path.join(run_dir, "church_adv_images.jpg"))
    if attack == "dp_noise":
        assert (adv - inputs).abs().mean() > 0.1
    if attack == "out_domain_more":
        assert torch.equal(adv, target.expand_as(inputs))
    if attack == "adv_generate":
        assert torch.equal(adv, inputs)
    if attack == "patch_white_box":
        assert os.path.exists(os.path.join(run_dir, "patch.npz"))
        assert len(open(os.path.join(run_dir, "loss_patch_white_box.txt")).readlines()) \
            == N * 2


def test_patch_white_box_reuses_a_saved_patch(tiny, tmp_path):
    p, inputs, target = tiny
    cfg = AttackRunConfig(dataset_name="church", max_count=2, patch_size=0.2)
    (adv,) = runner.dispatch_attack(p, "patch_white_box", inputs, target, cfg,
                                    torch.Generator().manual_seed(9), run_dir=str(tmp_path))
    reuse = AttackRunConfig(dataset_name="church", regenerate=False,
                            patch_npz=str(tmp_path / "patch.npz"))
    (adv2,) = runner.dispatch_attack(p, "patch_white_box", inputs, target, reuse,
                                     torch.Generator().manual_seed(10))
    assert torch.equal(adv2, adv)
    with pytest.raises(ValueError, match="patch_npz"):
        runner.dispatch_attack(p, "patch_white_box", inputs, target,
                               AttackRunConfig(dataset_name="church", regenerate=False),
                               torch.Generator())


def test_unknown_attack_mesh_and_execution_rules(tiny):
    p, inputs, target = tiny
    cfg = AttackRunConfig(dataset_name="church")
    with pytest.raises(ValueError, match="unknown attack"):
        runner.dispatch_attack(p, "nope", inputs, target, cfg, torch.Generator())
    # grad accumulation with a multi-device mesh: JAX's refusal, raised
    # before the mesh is used (a stand-in with DeviceMesh's size())
    accum = AttackRunConfig(dataset_name="church", n_iters=1, whitebox_grad_accum=2,
                            attacks=("white_box_target",))
    wide = types.SimpleNamespace(size=lambda dim=None: 4)
    for attack in ("white_box_target", "white_box_patch"):
        with pytest.raises(ValueError, match="single-chip activation lever"):
            runner.dispatch_attack(p, attack, inputs, target, accum, torch.Generator(),
                                   mesh=wide)
    with pytest.raises(ValueError, match="single-chip activation lever"):
        runner.run_experiment(p, accum, inputs, target, torch.Generator(),
                              mesh=types.SimpleNamespace(size=lambda dim=None: 2))
    # a one-device mesh is the single-device path
    from tpufusion_torch.parallel import create_mesh

    one = create_mesh("cpu", data=1)
    assert len(runner.dispatch_attack(p, "blur", inputs, target, cfg, torch.Generator(),
                                      mesh=one)) == 1
    for execution, snaps in (("auto", True), ("auto", False), ("scan", True),
                             ("stepwise", False)):
        assert runner.resolve_whitebox_execution(execution, snaps) == \
            j_runner.resolve_whitebox_execution(execution, snaps)
    with pytest.raises(ValueError, match="whitebox_execution"):
        runner.resolve_whitebox_execution("fast", True)
    bad = AttackRunConfig(dataset_name="church", n_iters=1, whitebox_grad_accum=2,
                          whitebox_execution="scan")
    with pytest.raises(ValueError, match="grad_accum"):
        runner.dispatch_attack(p, "white_box_target", inputs, target, bad, torch.Generator())


def test_whitebox_snapshots_and_grad_accum_through_the_runner(tiny, tmp_path):
    p, inputs, target = tiny
    cfg = AttackRunConfig(dataset_name="church", attacks=("white_box_target",), n_iters=3,
                          snapshot_every=2, whitebox_grad_accum=2)
    res = runner.run_experiment(p, cfg, inputs, target, torch.Generator().manual_seed(1),
                                save_root=str(tmp_path))
    run_dir = res["_run_dirs"]["white_box_target"]
    names = set(os.listdir(run_dir))
    assert {"adv_input_white_box_target_2.png", "rec_white_box_target_2.png"} <= names
    assert len([n for n in names if n.startswith("adv_input_")]) == 1  # k * 2 + 1 < 3 steps
    params = json.load(open(os.path.join(run_dir, "parameters.json")))
    assert params["whitebox grad_accum"] == 2


def test_fgsm_records_real_semantics_and_hybrid(tiny, tmp_path):
    p, inputs, target = tiny
    cfg = AttackRunConfig(dataset_name="church", attacks=("fgsm", "out_domain_more"),
                          hybrid_adv=True)
    res = runner.run_experiment(p, cfg, inputs, target, torch.Generator().manual_seed(2),
                                save_root=str(tmp_path))
    params = json.load(open(os.path.join(res["_run_dirs"]["fgsm"], "parameters.json")))
    assert params["attack semantics"] == "r+fgsm (random_start, steps=1)"
    assert res["hybrid"]["counts"] == [2, 1] and res["hybrid"]["inputs"].shape == inputs.shape
    assert any("hybrid_attack" in d for d in os.listdir(tmp_path))


def test_discriminator_scores(tiny):
    from tpufusion_torch.models.discriminator import create_discriminator, realism_scores

    p, inputs, target = tiny
    d = create_discriminator(32, channel_multiplier=1, device="cpu")
    cfg = AttackRunConfig(dataset_name="church", attacks=("out_domain_more",))
    res = runner.run_experiment(p, cfg, inputs, target, torch.Generator(), discriminator=d)
    assert res["realism"]["inputs"].shape == (N,)
    assert res["realism"]["fused_spatial"].shape == (1,)
    r = res["out_domain_more"][0]
    with torch.no_grad():
        want = realism_scores(d, r["partial_spatial"][-1:])
    assert torch.equal(r["adv_realism"], want)


def test_adv_override_and_mid_run_flush(tiny, tmp_path, monkeypatch):
    """Precomputed batches and evaluations replace the dispatch; with
    ``flush_every=1`` the npz is on disk before the last batch is tabled."""
    p, inputs, target = tiny
    seen = []
    orig = runner.ResultsTable.add_batch

    def spy(self, *a, **k):
        seen.extend(r for r, _, fs in os.walk(tmp_path) if "all_adv_inputs.npz" in fs)
        return orig(self, *a, **k)

    monkeypatch.setattr(runner.ResultsTable, "add_batch", spy)

    def dispatch(*a, **k):
        raise AssertionError("the override must replace the dispatch")

    monkeypatch.setattr(runner, "dispatch_attack", dispatch)
    parts = torch.zeros(N + 1, 32, 32, 3)
    pre = dict(noise=torch.full((N,), 0.5), part_sp=parts, part_ar=parts,
               **{k: torch.arange(N + 1.0) for k in ("cri_sp", "vg_sp", "ss_sp",
                                                      "cri_ar", "vg_ar", "ss_ar")})
    override = {"blur": {"batches": [inputs * 0.5, inputs * 0.25], "trace": torch.ones(3),
                         "evals": [pre, pre]}}
    cfg = AttackRunConfig(dataset_name="church", attacks=("blur",), flush_every=1)
    res = runner.run_experiment(p, cfg, inputs, target, torch.Generator(),
                                save_root=str(tmp_path), adv_override=override)
    run_dir = res["_run_dirs"]["blur"]
    assert seen, "all_adv_inputs.npz never appeared mid-experiment"
    assert len(open(os.path.join(run_dir, "loss_blur.txt")).readlines()) == 3
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "results.jsonl"))]
    assert [r["noise_mse"] for r in rows] == [0.5, 0.5]
    assert rows[1]["ssim_arith"] == [0.0, 1.0, 2.0, 3.0]
    adv = np.load(os.path.join(run_dir, "adversarial", "all_adv_inputs.npz"))["data"]
    np.testing.assert_array_equal(adv, torch.cat([inputs * 0.5, inputs * 0.25]).numpy())


def test_transfer_chain_and_generate_inputs(tiny, tmp_path):
    p, inputs, target = tiny
    x = runner.generate_inputs(p, 3, torch.Generator().manual_seed(4))
    assert x.shape == (3, 32, 32, 3) and x.min() >= -1 and x.max() <= 1
    assert torch.equal(x, runner.generate_inputs(p, 3, torch.Generator().manual_seed(4)))
    cfg = AttackRunConfig(dataset_name="church", pgd_steps=2)
    chain = runner.run_transfer_chain(p, cfg, inputs, target, torch.Generator().manual_seed(5),
                                      str(tmp_path))
    assert os.path.exists(chain["adv_inputs_path"])
    np.testing.assert_array_equal(
        chain["fuse"]["adv_generate"][0]["adv_inputs"].numpy(),
        chain["generate"]["pgd_classifier"][0]["adv_inputs"].numpy())


def test_classifier_for_picks_the_dataset_model():
    from tpufusion_torch.pipeline import create_test_pipeline

    car = create_test_pipeline("car", device="cpu")
    logits_fn, model = runner.classifier_for(car, AttackRunConfig(dataset_name="car"),
                                             torch.Generator())
    assert logits_fn(model, torch.zeros(2, 32, 32, 3)).shape == (2, 8)  # tiny ViT

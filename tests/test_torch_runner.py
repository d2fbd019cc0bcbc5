"""The port's runner (``tpufusion_torch/runner.py``) against the JAX
package's, on the FFHQ 32^2 test pipeline (N = 5) whose weights are carried
into the port (``tests/torch_pipelines.py::port_of``). CPU, float32.

- ``run_experiment`` in both packages, the same inputs, target and
  ``save_root``, on the deterministic attacks (``white_box_target`` at 2
  iterations, ``blur``, ``patch``, ``out_domain_single``, ``adv_generate``):
  the same run-folder tree and file names; ``results.jsonl`` (noise, cri, vg
  and ssim in both modes) and the ``.npz`` artifacts to 2e-4, the white-box
  pixels within 0.2 lr (``tests/test_torch_whitebox.py``'s bound); both
  readers read each ``new_mask.xlsx``;
- (``tests/test_torch_dispatch.py`` runs every attack of ``ATTACK_CHOICES``
  and the runner's other paths on the port's own church pipeline);
- the resumable white-box, interrupted and resumed, equals an unbroken run
  bit for bit;
- artifacts written by one package load through the other's
  ``adv_generate``, ``load_existing_inputs`` and ``run_hybrid_from_dirs``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pipelines import one_torch_thread, port_of  # noqa: F401
from tpufusion import runner as j_runner
from tpufusion.configs import AttackRunConfig as JConfig
from tpufusion.configs import PathsConfig as JPaths
from tpufusion.io.xlsx import read_xlsx as j_read_xlsx
from tpufusion.pipeline import create_test_pipeline as j_create_test_pipeline
from tpufusion_torch import runner
from tpufusion_torch.attacks.whitebox import WhiteboxConfig, run_whitebox_stepwise
from tpufusion_torch.configs import AttackRunConfig, PathsConfig
from tpufusion_torch.io import ArtifactStore, load_attack_state, run_whitebox_resumable
from tpufusion_torch.io.attack_state import save_attack_state
from tpufusion_torch.io.xlsx import read_xlsx

TOL = dict(atol=2e-4, rtol=2e-4)
N = 5
LR = 1e-4  # AttackRunConfig's white-box lr
PARITY_ATTACKS = ("white_box_target", "blur", "patch", "out_domain_single", "adv_generate")
METRICS = ("cri_spatial", "cri_arith", "vg_spatial", "vg_arith", "ssim_spatial", "ssim_arith")


@pytest.fixture(scope="module")
def pipelines():
    jp = j_create_test_pipeline("ffhq", jax.random.key(0), size=32)
    return jp, port_of(jp)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(31)
    inputs = rng.uniform(-0.9, 0.9, (N, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    return inputs, target


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _rows(run_dir):
    with open(os.path.join(run_dir, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def parity_runs(pipelines, batch, tmp_path_factory):
    """``run_experiment`` of both packages into their own save roots."""
    jp, tp = pipelines
    inputs, target = batch
    root = tmp_path_factory.mktemp("runner")
    adv_src = str(root / "adv_src.npz")
    np.savez(adv_src, data=np.clip(inputs + 0.1, -1, 1))
    common = dict(dataset_name="ffhq", attacks=PARITY_ATTACKS, n_iters=2, scale=0.2)
    jcfg = JConfig(**common, paths=JPaths(adv_inputs_path=adv_src))
    tcfg = AttackRunConfig(**common, paths=PathsConfig(adv_inputs_path=adv_src))
    jres = j_runner.run_experiment(jp, jcfg, jnp.asarray(inputs), jnp.asarray(target),
                                   jax.random.key(5), save_root=str(root / "jax"))
    tres = runner.run_experiment(tp, tcfg, torch.from_numpy(inputs), torch.from_numpy(target),
                                 torch.Generator().manual_seed(5), save_root=str(root / "port"))
    return root, jres, tres


def test_run_folder_trees_match(parity_runs):
    root, jres, tres = parity_runs
    assert _tree(root / "port") == _tree(root / "jax")
    names = sorted(os.listdir(root / "port"))
    assert names == sorted(os.listdir(root / "jax"))
    assert names[0].startswith("0_ffhq_white_box_target_2_0.00010_[]")
    for attack in PARITY_ATTACKS:
        assert os.path.basename(tres["_run_dirs"][attack]) == \
            os.path.basename(jres["_run_dirs"][attack])


@pytest.mark.parametrize("attack", PARITY_ATTACKS)
def test_results_jsonl_and_xlsx_match(parity_runs, attack):
    root, jres, tres = parity_runs
    jrows, trows = _rows(jres["_run_dirs"][attack]), _rows(tres["_run_dirs"][attack])
    assert len(trows) == len(jrows) == (N if attack == "out_domain_single" else 1)
    for jr, tr in zip(jrows, trows):
        assert tr.keys() == jr.keys() and tr["attack"] == attack
        np.testing.assert_allclose(tr["noise_mse"], jr["noise_mse"], **TOL)
        for k in METRICS:
            assert len(tr[k]) == N + 1
            np.testing.assert_allclose(tr[k], jr[k], **TOL, err_msg=f"{attack} {k}")
    path = os.path.join(tres["_run_dirs"][attack], "new_mask.xlsx")
    jpath = os.path.join(jres["_run_dirs"][attack], "new_mask.xlsx")
    for reader in (read_xlsx, j_read_xlsx):
        (cols, rows), (jcols, jrows_x) = reader(path), reader(jpath)
        assert cols == jcols and len(cols) == N + 6 * (N + 1)
        np.testing.assert_allclose(np.array(rows, float), np.array(jrows_x, float), **TOL)


@pytest.mark.parametrize("attack", PARITY_ATTACKS)
def test_npz_artifacts_match(parity_runs, batch, attack):
    root, jres, tres = parity_runs
    jdir = os.path.join(jres["_run_dirs"][attack], "adversarial")
    tdir = os.path.join(tres["_run_dirs"][attack], "adversarial")
    names = sorted(f for f in os.listdir(tdir) if f.endswith(".npz"))
    assert names == sorted(f for f in os.listdir(jdir) if f.endswith(".npz"))
    assert names == ["all_adv_inputs.npz", "all_adv_rec_loss.npz", "all_inner_feature.npz",
                     "all_inputs.npz", "all_rec_loss.npz"]
    for name in names:
        got = ArtifactStore.load(os.path.join(tdir, name))
        want = ArtifactStore.load(os.path.join(jdir, name))
        assert got.shape == want.shape, name
        if attack == "white_box_target" and name == "all_adv_inputs.npz":
            # Adam's bound: lr per step; the packages within 0.2 lr
            np.testing.assert_allclose(got, want, atol=0.2 * LR, rtol=0)
            assert np.abs(got - batch[0]).max() > 0.5 * LR
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=f"{attack} {name}")
    np.testing.assert_array_equal(ArtifactStore.load(os.path.join(tdir, "all_inputs.npz")),
                                  batch[0])


def test_results_dicts_match(parity_runs):
    root, jres, tres = parity_runs
    for k in ("fused_spatial", "fused_arith", "rec_loss"):
        np.testing.assert_allclose(tres["benign"][k].numpy(), np.asarray(jres["benign"][k]),
                                   **TOL, err_msg=k)
    assert tres["realism"] is None and jres["realism"] is None
    assert len(tres["out_domain_single"]) == N
    r, jr = tres["blur"][0], jres["blur"][0]
    for k in ("partial_spatial", "partial_arith", "noise"):
        np.testing.assert_allclose(r[k].numpy(), np.asarray(jr[k]), **TOL, err_msg=k)


def test_resumable_whitebox_equals_an_unbroken_run(pipelines, batch, tmp_path):
    _, p = pipelines
    x, target = (torch.from_numpy(a) for a in batch)
    x = x[:2]
    cfg = WhiteboxConfig(n_iters=3, lr=1e-2)
    full_adv, full_trace = run_whitebox_stepwise(p, x, target, cfg)
    ckpt = str(tmp_path / "wb.npz")
    # "interrupted" after 1 iteration: the same attack with a shorter budget
    adv1, tr1, start1 = run_whitebox_resumable(p, x, target, dataclasses.replace(cfg, n_iters=1),
                                               ckpt, checkpoint_every=1)
    assert start1 == 0 and tr1["total"].shape == (1,)
    adv, tr, start = run_whitebox_resumable(p, x, target, cfg, ckpt, checkpoint_every=1)
    assert start == 1 and tr["total"].shape == (2,)
    assert torch.equal(adv, full_adv)
    assert torch.equal(torch.cat([tr1["total"], tr["total"]]), full_trace["total"])
    # already complete: nothing runs
    adv3, tr3, start3 = run_whitebox_resumable(p, x, target, cfg, ckpt)
    assert start3 == 3 and tr3 is None and torch.equal(adv3, full_adv)


def test_attack_state_roundtrip_and_mismatch(pipelines, batch, tmp_path):
    from tpufusion_torch.attacks.whitebox import make_whitebox_stepper

    _, p = pipelines
    inputs, target = (torch.from_numpy(a) for a in batch)
    init, step = make_whitebox_stepper(p, WhiteboxConfig(n_iters=1))
    state, _ = step(init(inputs[:2], target))
    path = save_attack_state(state, str(tmp_path / "s.npz"), step=1)
    back, n = load_attack_state(path, init(inputs[:2], target))
    assert n == 1 and back["opt_state"]["count"] == 1
    assert isinstance(back["ref"]["feats_org"], tuple)
    for k in ("x",):
        assert torch.equal(back[k], state[k])
    assert torch.equal(back["opt_state"]["nu"], state["opt_state"]["nu"])
    with pytest.raises(ValueError, match="shape"):
        load_attack_state(path, init(inputs[:3], target))
    with pytest.raises(ValueError, match="leaves"):
        load_attack_state(path, {"x": state["x"]})


def test_artifacts_cross_between_the_packages(pipelines, parity_runs, batch, tmp_path):
    """The JAX run's npz through the port's adv_generate, existing-inputs
    loader and hybrid splice; the port's npz and montage through JAX's."""
    jp, tp = pipelines
    root, jres, tres = parity_runs
    inputs, target = batch
    jdir, tdir = jres["_run_dirs"]["blur"], tres["_run_dirs"]["blur"]
    j_npz = os.path.join(jdir, "adversarial", "all_adv_inputs.npz")
    t_npz = os.path.join(tdir, "adversarial", "all_adv_inputs.npz")
    cfg = AttackRunConfig(dataset_name="ffhq", paths=PathsConfig(adv_inputs_path=j_npz))
    (adv,) = runner.dispatch_attack(tp, "adv_generate", torch.from_numpy(inputs),
                                    torch.from_numpy(target), cfg, torch.Generator())
    np.testing.assert_array_equal(adv.numpy(), ArtifactStore.load(j_npz))
    got = runner.load_existing_inputs(os.path.join(jdir, "adversarial", "all_inputs.npz"),
                                      N, 32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), inputs)
    jcfg = JConfig(dataset_name="ffhq", paths=JPaths(adv_inputs_path=t_npz))
    (jadv,) = j_runner.dispatch_attack(jp, "adv_generate", jnp.asarray(inputs),
                                       jnp.asarray(target), jcfg, jax.random.key(0))
    np.testing.assert_array_equal(np.asarray(jadv), ArtifactStore.load(t_npz))
    montage = os.path.join(tdir, "adversarial", "adv_inputs_0_0_all.jpg")
    jm = j_runner.load_existing_inputs(montage, N, 32)
    tm = runner.load_existing_inputs(montage, N, 32, device="cpu")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # the hybrid splice over one JAX and one port run folder
    both = tmp_path / "both"
    for name, src in (("0_ffhq_blur", jdir), ("1_ffhq_patch", tres["_run_dirs"]["patch"])):
        os.makedirs(both / name / "adversarial")
        a = ArtifactStore.load(os.path.join(src, "adversarial", "all_adv_inputs.npz"))
        np.savez(both / name / "adversarial" / "all_adv_inputs.npz", data=a)
    hyb = runner.run_hybrid_from_dirs(tp, AttackRunConfig(dataset_name="ffhq"), str(both),
                                      ["0_ffhq_blur", "1_ffhq_patch"], save_root=str(both))
    jhyb = j_runner.run_hybrid_from_dirs(jp, JConfig(dataset_name="ffhq"), str(both),
                                         ["0_ffhq_blur", "1_ffhq_patch"])
    assert hyb["counts"] == jhyb["counts"] == [3, 2]
    np.testing.assert_array_equal(hyb["inputs"].numpy(), np.asarray(jhyb["inputs"]))
    np.testing.assert_allclose(hyb["fused"].numpy(), np.asarray(jhyb["fused"]), **TOL)
    assert any("hybrid_attack" in d for d in os.listdir(both))

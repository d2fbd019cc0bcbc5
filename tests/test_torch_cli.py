"""The port's command-line tools (``tpufusion_torch/cli/{attack_run,
invert,fuse}.py``) at ``--tiny --device cpu``, on 32^2 church pipelines:
preset resolution and its round trips, an explicit flag at its default
beating the preset, the preset's seed, the fail-fast checks (no attacks, an
unknown attack, a ``--mesh`` beyond the world size, no card without ``--device cpu``, the transfer
chain without saved images), ``--max_num_fusion``, ``--align`` through the
landmark net, saved inputs and run folders from the JAX package, and the
files ``invert`` and ``fuse`` write."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tpufusion_torch.cli import attack_run, fuse, invert

TINY = ["--tiny", "--size", "32", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def no_process_group_left():
    """The one-rank groups that meshes start here end with the module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _run(*argv):
    assert attack_run.main([*TINY, *argv]) == 0


def _preset(path, **fields):
    path.write_text(json.dumps(fields))
    return str(path)


def _noise_mse(ds_dir, attack="dp_noise"):
    (adir,) = [x for x in os.listdir(ds_dir) if attack in x]
    with open(os.path.join(ds_dir, adir, "results.jsonl")) as f:
        return json.loads(f.readline())["noise_mse"]


def test_attack_run_writes_one_run_folder_per_group(tmp_path):
    _run("--dataset", "church", "--attacks", "dp_noise", "--max_num_fusion", "2",
         "--save_dir", str(tmp_path))
    runs = sorted(os.listdir(tmp_path / "church"))
    assert runs == ["0_church_dp_noise", "1_church_dp_noise"]
    names = set(os.listdir(tmp_path / "church" / runs[0]))
    assert {"parameters.txt", "parameters.json", "results.jsonl", "new_mask.xlsx",
            "benign", "adversarial"} <= names
    params = json.load(open(tmp_path / "church" / runs[0] / "parameters.json"))
    assert params["use_generate_img"] is True  # no --images_dir: generated inputs


def test_preset_paths_and_flags_round_trip(tmp_path):
    """A preset's target image and the flags outside the override table
    (--max_num_fusion, --no_save_img) take effect with --config."""
    tgt = tmp_path / "target.png"
    Image.fromarray((np.linspace(0, 255, 32 * 32 * 3) % 255).astype(np.uint8)
                    .reshape(32, 32, 3)).save(tgt)
    preset = _preset(tmp_path / "p.json", dataset_name="church", attacks=["dp_noise"],
                     paths={"target_image": str(tgt)})
    _run("--config", preset, "--max_num_fusion", "2", "--no_save_img",
         "--save_dir", str(tmp_path / "runs"))
    assert not os.listdir(tmp_path / "runs" / "church")  # --no_save_img honoured


def test_snapshot_and_flush_flags_override_the_preset(tmp_path):
    preset = _preset(tmp_path / "p.json", dataset_name="church",
                     attacks=["white_box_target"], n_iters=2, snapshot_every=1)
    _run("--config", preset, "--snapshot_every", "0", "--flush_every", "1",
         "--save_dir", str(tmp_path / "runs"))
    (run,) = os.listdir(tmp_path / "runs" / "church")
    assert run == "0_church_white_box_target_2_0.00010_[]"
    assert not [n for n in os.listdir(tmp_path / "runs" / "church" / run)
                if n.startswith("adv_input_")]


def test_explicit_default_beats_the_preset(tmp_path):
    preset = _preset(tmp_path / "p.json", dataset_name="church", attacks=["dp_noise"])
    _run("--config", preset, "--dataset", "ffhq", "--save_dir", str(tmp_path / "runs"))
    assert os.path.isdir(tmp_path / "runs" / "ffhq")
    assert not os.path.exists(tmp_path / "runs" / "church")


def test_preset_seed_is_honoured(tmp_path):
    noise = {}
    for name, seed in (("a", 1), ("b", 1), ("c", 2)):
        preset = _preset(tmp_path / f"{name}.json", dataset_name="church",
                         attacks=["dp_noise"], seed=seed)
        _run("--config", preset, "--save_dir", str(tmp_path / name))
        noise[name] = _noise_mse(tmp_path / name / "church")
    assert noise["a"] == noise["b"] != noise["c"]


def test_fail_fast_checks(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="no attacks"):
        attack_run.main(["--attacks", *TINY, "--save_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="unknown attack"):
        attack_run.main(["--attacks", "nope", *TINY, "--save_dir", str(tmp_path)])
    # a mesh must cover the process group: this process is a one-rank world
    with pytest.raises(SystemExit, match="world size 1"):
        attack_run.main(["--mesh", "data=4", *TINY, "--save_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="world size 1"):
        invert.main(["--images_dir", str(tmp_path), "--mesh", "4", *TINY])
    with pytest.raises(SystemExit, match="transfer_chain"):
        attack_run.main(["--dataset", "church", *TINY, "--transfer_chain", "--no_save_img",
                         "--save_dir", str(tmp_path / "runs")])
    # no card and no --device cpu: the CLIs raise before any work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((attack_run.main, ["--tiny", "--save_dir", str(tmp_path / "x")]),
                       (invert.main, ["--images_dir", str(tmp_path), "--tiny"]),
                       (fuse.main, ["--tiny", "--out", str(tmp_path / "f.jpg")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert not os.path.exists(tmp_path / "x")


@pytest.fixture()
def faces(tmp_path):
    """8 synthetic faces at 160^2, and the packaged landmark net's weights
    (its input size comes from the stem sidecar)."""
    from tpufusion_torch.core.imaging import to_uint8
    from tpufusion_torch.models.landmarks import WEIGHTS_DIR, synth_face_batch

    img_dir = tmp_path / "faces"
    img_dir.mkdir()
    imgs, _ = synth_face_batch(np.random.RandomState(11), 8, 160, augment=True)
    for i, img in enumerate(imgs):
        Image.fromarray(to_uint8(img)).save(img_dir / f"{i}.png")
    return str(img_dir), os.path.join(WEIGHTS_DIR, "landmark_net.npz")


def test_align_path_from_images_on_disk(faces, tmp_path):
    img_dir, weights = faces
    _run("--dataset", "church", "--attacks", "blur", "--images_dir", img_dir, "--align",
         "--landmark_net", weights, "--test_size", "8", "--save_dir", str(tmp_path / "runs"))
    (run,) = os.listdir(tmp_path / "runs" / "church")
    x = np.load(tmp_path / "runs" / "church" / run / "adversarial" / "all_inputs.npz")["data"]
    assert x.shape == (3, 32, 32, 3) and np.isfinite(x).all()


def test_invert_and_fuse_write_their_files(faces, tmp_path):
    img_dir, weights = faces
    out = tmp_path / "inv"
    assert invert.main(["--images_dir", img_dir, "--dataset", "church", *TINY, "--batch", "3",
                        "--n_sample", "4", "--save_dir", str(out)]) == 0
    lat = np.load(out / "latents.npz")["latents"]
    assert lat.shape[0] == 4 and np.isfinite(lat).all()
    assert sorted(os.listdir(out / "inversions")) == [f"{i:05d}.jpg" for i in range(1, 5)]
    aligned = tmp_path / "inv_align"
    assert invert.main(["--images_dir", img_dir, "--dataset", "church", *TINY, "--align",
                        "--landmark_net", weights, "--latents_only", "--n_sample", "2",
                        "--save_dir", str(aligned)]) == 0
    assert np.load(aligned / "latents.npz")["latents"].shape[0] == 2
    assert not os.path.exists(aligned / "inversions")
    demo = str(tmp_path / "demo.jpg")
    assert fuse.main(["--dataset", "church", *TINY, "--out", demo]) == 0
    assert Image.open(demo).size == (6 * 34 + 2, 36)  # 5 parts + the fusion


def test_jax_artifacts_drive_the_cli(tmp_path):
    """All_inputs.npz written by the JAX package's ArtifactStore feeds
    --inputs_path; run folders holding JAX-written all_adv_inputs.npz feed
    --hybrid_from_dirs."""
    from tpufusion.io import ArtifactStore as JArtifactStore

    x = np.random.RandomState(0).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    store = JArtifactStore(str(tmp_path / "saved"))
    store.append("all_inputs", x)
    path = store.flush()["all_inputs"]
    _run("--dataset", "church", "--attacks", "out_domain_more", "--inputs_path", path,
         "--save_dir", str(tmp_path / "runs"))
    (run,) = os.listdir(tmp_path / "runs" / "church")
    np.testing.assert_array_equal(
        np.load(tmp_path / "runs" / "church" / run / "adversarial" / "all_inputs.npz")["data"], x)
    for i, name in enumerate(("0_church_dp_noise", "1_church_pgd")):
        s = JArtifactStore(str(tmp_path / "runs" / "church" / name / "adversarial"))
        s.append("all_adv_inputs", np.clip(x + 0.1 * (i + 1), -1, 1))
        s.flush()
    _run("--dataset", "church", "--hybrid_from_dirs", "0_church_dp_noise", "1_church_pgd",
         "--save_dir", str(tmp_path / "runs"))
    hybrid = [d for d in os.listdir(tmp_path / "runs" / "church") if "hybrid" in d]
    assert hybrid
    assert os.path.isfile(tmp_path / "runs" / "church" / hybrid[0] / "hybrid_fusion.jpg")

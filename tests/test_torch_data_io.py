"""The port's data, IO, report and utility modules
(``tpufusion_torch/{configs,data,io,eval/report,utils}``): the cases of
``tests/test_data_io.py`` and ``tests/test_native.py`` against the port, the
results table and its xlsx, tensors as inputs, and files that cross between
the packages."""

import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tpufusion import configs as j_configs
from tpufusion.data import native as j_native
from tpufusion.data import transform_for as j_transform_for
from tpufusion.eval.report import ResultsTable as JResultsTable
from tpufusion.io import ArtifactStore as JArtifactStore
from tpufusion.io import save_montage as j_save_montage
from tpufusion.io.xlsx import read_xlsx as j_read_xlsx
from tpufusion_torch import configs
from tpufusion_torch.configs import DATASET_N_DICT, ITER_DICT, AttackRunConfig
from tpufusion_torch.data import (
    BatchLoader,
    ImageFolderDataset,
    align_face,
    list_images,
    setup_loaders,
    transform_for,
)
from tpufusion_torch.data import native
from tpufusion_torch.data.adv_inputs import crop_montage_panels, load_adv_inputs
from tpufusion_torch.eval import ResultsTable
from tpufusion_torch.io import (
    ArtifactStore,
    load_image,
    new_adv_dir,
    new_run_folder,
    save_image,
    save_montage,
    write_parameters,
)
from tpufusion_torch.io.images import save_comparison_grid
from tpufusion_torch.io.xlsx import read_xlsx, write_xlsx
from tpufusion_torch.utils import EasyDict, Logger, trace_profile
from tpufusion_torch.utils.logging import aggregate_loss_dict

rng = np.random.RandomState(0)


@pytest.fixture()
def image_dir(tmp_path):
    root = tmp_path / "imgs"
    (root / "sub").mkdir(parents=True)
    r = np.random.RandomState(0)
    for i in range(6):
        arr = (r.rand(40, 40, 3) * 255).astype(np.uint8)
        sub = root / "sub" if i % 2 else root
        Image.fromarray(arr).save(sub / f"img_{i}.png")
    return str(root)


class TestDataset:
    def test_recursive_scan_sorted(self, image_dir):
        paths = list_images(image_dir)
        assert len(paths) == 6 and paths == sorted(paths)

    @pytest.mark.parametrize("dataset,split,shape", [
        ("ffhq", "inference", (256, 256, 3)), ("car", "test", (512, 512, 3)),
        ("church", "test", (256, 256, 3)), ("ffhq", "test", (1024, 1024, 3))])
    def test_transforms_match_jax(self, image_dir, dataset, split, shape):
        img = Image.open(list_images(image_dir)[0]).convert("RGB")
        got = transform_for(dataset, split)(img)
        assert got.shape == shape and got.min() >= -1.0 and got.max() <= 1.0
        np.testing.assert_array_equal(got, j_transform_for(dataset, split)(img))

    def test_missing_dir_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            ImageFolderDataset(str(tmp_path / "empty"))

    def test_batch_loader_shapes_and_order(self, image_dir):
        from tpufusion.data import BatchLoader as JBatchLoader
        from tpufusion.data import ImageFolderDataset as JImageFolderDataset

        ds = ImageFolderDataset(image_dir, transform=transform_for("church"))
        batches = list(BatchLoader(ds, np.arange(len(ds)), batch_size=2, seed=1))
        assert len(batches) == 3 and batches[0].shape == (2, 256, 256, 3)
        jds = JImageFolderDataset(image_dir, transform=j_transform_for("church"))
        for a, b in zip(batches, JBatchLoader(jds, np.arange(6), batch_size=2, seed=1)):
            np.testing.assert_array_equal(a, b)

    def test_setup_loaders_split_matches_jax(self, image_dir):
        from tpufusion.data import ImageFolderDataset as JImageFolderDataset
        from tpufusion.data import setup_loaders as j_setup_loaders

        ds = ImageFolderDataset(image_dir)
        train, test = setup_loaders(ds, train_size=4, test_size=2,
                                    train_batch_size=1, test_batch_size=2, seed=3)
        assert set(train.indices.tolist()).isdisjoint(test.indices.tolist())
        assert len(train.indices) == 4 and len(test.indices) == 2
        jtrain, jtest = j_setup_loaders(JImageFolderDataset(image_dir), train_size=4,
                                        test_size=2, train_batch_size=1,
                                        test_batch_size=2, seed=3)
        np.testing.assert_array_equal(train.indices, jtrain.indices)
        np.testing.assert_array_equal(test.indices, jtest.indices)

    def test_setup_loaders_empty_test_split_raises(self, image_dir):
        with pytest.raises(ValueError, match="test split"):
            setup_loaders(ImageFolderDataset(image_dir), train_size=6, test_size=2)

    def test_prefetch_surfaces_dataset_errors(self, image_dir):
        """A __getitem__ error (a corrupt image, or the landmark net failing
        inside the prefetch thread) reaches the consumer."""
        ds = ImageFolderDataset(image_dir)

        class Flaky:
            def __len__(self):
                return len(ds)

            def __getitem__(self, i):
                if i == 4:
                    raise RuntimeError("corrupt image")
                return ds[i]

        loader = BatchLoader(Flaky(), np.arange(6), batch_size=2, shuffle=False, prefetch=2)
        with pytest.raises(RuntimeError, match="corrupt image"):
            list(loader)

    def test_prefetch_worker_exits_on_early_break(self, image_dir):
        import gc
        import time

        ds = ImageFolderDataset(image_dir)
        before = {t.ident for t in threading.enumerate()}
        for _ in BatchLoader(ds, np.arange(6), batch_size=1, shuffle=False, prefetch=1):
            break
        gc.collect()
        deadline = time.time() + 5.0
        leftover = []
        while time.time() < deadline:
            leftover = [t for t in threading.enumerate()
                        if t.ident not in before and t.is_alive()]
            if not leftover:
                break
            time.sleep(0.05)
        assert not leftover, "prefetch worker still alive after early break"

    def test_align_with_synthetic_landmarks(self, image_dir):
        lm = np.zeros((68, 2))
        lm[36:42] = [14, 16]
        lm[42:48] = [26, 16]
        lm[48:60] = [20, 28]
        lm[48] = [15, 28]
        lm[54] = [25, 28]
        out = align_face(list_images(image_dir)[0], lm, output_size=64, transform_size=64)
        assert out.size == (64, 64)


class TestNative:
    """The port's own ctypes binding of ``native/``'s host library, held to
    its numpy fallback and to the JAX package's binding."""

    def test_normalize_and_roundtrip(self):
        u8 = (rng.rand(17, 23, 3) * 255).astype(np.uint8)
        out = native.normalize_u8_to_pm1(u8)
        np.testing.assert_allclose(out, u8.astype(np.float32) / 255 * 2 - 1, atol=1e-6)
        back = native.pm1_to_u8(out)
        assert np.abs(back.astype(int) - u8.astype(int)).max() <= 1

    def test_ops_match_jax_binding(self):
        u8 = (rng.rand(23, 17, 3) * 255).astype(np.uint8)
        f = rng.rand(5, 8, 8, 3).astype(np.float32)
        np.testing.assert_array_equal(native.resize_normalize(u8, 7, 5),
                                      j_native.resize_normalize(u8, 7, 5))
        np.testing.assert_array_equal(native.avg_pool(f, 2), j_native.avg_pool(f, 2))
        np.testing.assert_array_equal(native.montage_strip(f), j_native.montage_strip(f))
        assert native.montage_strip(f, padding=2).shape == (12, 5 * 10 + 2, 3)

    def test_numpy_fallback_matches_the_library(self, monkeypatch):
        u8 = (rng.rand(2, 2, 3) * 255).astype(np.uint8)
        big = (rng.rand(23, 17, 3) * 255).astype(np.uint8)
        f = rng.rand(2, 8, 12, 3).astype(np.float32)
        pm1 = rng.uniform(-1.2, 1.2, (9, 9, 3)).astype(np.float32)
        want = [native.resize_normalize(u8, 8, 8), native.resize_normalize(big, 7, 5),
                native.avg_pool(f, 2), native.montage_strip(f[:, :4, :4]),
                native.normalize_u8_to_pm1(big), native.pm1_to_u8(pm1)]
        monkeypatch.setattr(native, "_load", lambda: None)
        got = [native.resize_normalize(u8, 8, 8), native.resize_normalize(big, 7, 5),
               native.avg_pool(f, 2), native.montage_strip(f[:, :4, :4]),
               native.normalize_u8_to_pm1(big), native.pm1_to_u8(pm1)]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-4)


class TestArtifacts:
    def test_new_adv_dir_numbering(self, tmp_path):
        from tpufusion.io import new_adv_dir as j_new_adv_dir

        base = str(tmp_path / "runs")
        assert os.path.basename(new_adv_dir(base, "ffhq_pgd")) == "0_ffhq_pgd"
        # the two packages number one folder alike
        assert os.path.basename(j_new_adv_dir(base, "ffhq_pgd")) == "1_ffhq_pgd"
        assert os.path.basename(new_adv_dir(base, "ffhq_blur")) == "2_ffhq_blur"

    def test_parameters_record_and_sidecar_merge(self, tmp_path):
        run = new_run_folder(str(tmp_path / "run"))
        p = write_parameters(run, {"attack": "pgd", "lr": 0.01})
        assert "attack pgd" in open(p).read() and "lr 0.01" in open(p).read()
        write_parameters(run, {"lr": 0.02, "n": np.int64(3)})
        assert open(p).read().count("lr ") == 2
        rec = json.load(open(os.path.join(run, "parameters.json")))
        assert rec == {"attack": "pgd", "lr": 0.02, "n": repr(np.int64(3))}

    def test_artifact_store_takes_tensors_and_crosses_packages(self, tmp_path):
        store = ArtifactStore(str(tmp_path / "art"))
        store.append("all_inputs", torch.ones(2, 4))
        store.append("all_inputs", np.zeros((3, 4), np.float32))
        store.append("all_inner_feature", torch.full((1, 2), 0.5, dtype=torch.bfloat16))
        written = store.flush()
        data = ArtifactStore.load(written["all_inputs"])
        assert data.shape == (5, 4) and data.dtype == np.float32
        assert ArtifactStore.load(written["all_inner_feature"]).dtype == np.float32
        np.testing.assert_array_equal(JArtifactStore.load(written["all_inputs"]), data)
        jstore = JArtifactStore(str(tmp_path / "jart"))
        jstore.append("all_adv_inputs", np.arange(6, dtype=np.float32).reshape(2, 3))
        np.testing.assert_array_equal(ArtifactStore.load(jstore.flush()["all_adv_inputs"]),
                                      np.arange(6, dtype=np.float32).reshape(2, 3))


class TestImagesIO:
    def test_save_load_roundtrip_from_a_tensor(self, tmp_path):
        img = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (1, 16, 16, 3))
                               .astype(np.float32))
        back = load_image(save_image(img, str(tmp_path / "x.png")))
        assert back.shape == (1, 16, 16, 3)
        np.testing.assert_allclose(back, img.numpy(), atol=2 / 255 + 1e-3)

    def test_montage_matches_jax_and_crops_back(self, tmp_path):
        batch = np.random.RandomState(1).uniform(-1, 1, (5, 8, 8, 3)).astype(np.float32)
        p = save_montage(torch.from_numpy(batch), str(tmp_path / "grid.png"), nrow=5)
        q = j_save_montage(batch, str(tmp_path / "jgrid.png"), nrow=5)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(q)))
        crops = crop_montage_panels(p, 5, 8)
        np.testing.assert_allclose(crops, batch, atol=2 / 255 + 1e-3)
        np.testing.assert_array_equal(load_adv_inputs(p, 5, 8), crops)

    def test_comparison_grid(self, tmp_path):
        img = torch.zeros(8, 8, 3)
        p = save_comparison_grid([dict(input_face=img, target_face=img, output_face=img)] * 2,
                                 str(tmp_path / "cmp.png"))
        assert Image.open(p).size == (24, 16)

    def test_adv_inputs_npz_and_errors(self, tmp_path):
        store = ArtifactStore(str(tmp_path))
        store.append("all_adv_inputs", np.zeros((3, 4, 4, 3), np.float32))
        path = store.flush()["all_adv_inputs"]
        assert load_adv_inputs(path, 2, 4).shape == (2, 4, 4, 3)
        with pytest.raises(ValueError, match="need 5"):
            load_adv_inputs(path, 5, 4)
        with pytest.raises(ValueError, match="unsupported"):
            load_adv_inputs(str(tmp_path / "x.bin"), 1, 4)


class TestResultsTable:
    def _filled(self, table_cls, values):
        t = table_cls(2)
        t.add_batch(*values)
        return t

    def test_xlsx_roundtrip_matches_jax_layout(self, tmp_path):
        vals = [np.float32([0.1, 0.2])] + [np.float32([i, i + 0.5, np.nan]) for i in range(6)]
        t = self._filled(ResultsTable, [torch.from_numpy(v) for v in vals])
        j = self._filled(JResultsTable, vals)
        assert t.columns == j.columns and len(t.columns) == 2 + 6 * 3
        np.testing.assert_array_equal(np.array(t.rows), np.array(j.rows))
        path = t.save(str(tmp_path / "new_mask.xlsx"))
        for reader in (read_xlsx, j_read_xlsx):
            cols, rows = reader(path)
            assert cols == t.columns
            assert rows[0][:2] == [float(np.float32(0.1)), float(np.float32(0.2))]
            assert rows[0][4] is None  # NaN -> blank

    def test_wrong_length_raises_and_csv(self, tmp_path):
        t = ResultsTable(2)
        with pytest.raises(ValueError, match="expected 2"):
            t.add_batch([1.0], *([[0.0] * 3] * 6))
        t.add_batch([1.0, 2.0], *([[0.0] * 3] * 6))
        p = t.save(str(tmp_path / "table.csv"))
        assert open(p).read().splitlines()[0].startswith("noise,noise,cri_spati")

    def test_write_read_xlsx_cells(self, tmp_path):
        p = write_xlsx(str(tmp_path / "t.xlsx"), ["a", "b&c"],
                       [[1, 2.5], [True, "x<y"], [np.float32(1.5), np.int64(7)]])
        cols, rows = read_xlsx(p)
        assert cols == ["a", "b&c"]
        assert rows == [[1.0, 2.5], ["True", "x<y"], [1.5, 7.0]]


class TestUtils:
    def test_easydict(self):
        d = EasyDict(a=1)
        d.b = 2
        assert d.a == 1 and d["b"] == 2
        with pytest.raises(AttributeError):
            _ = d.missing

    def test_logger_tees_stdout_and_stderr(self, tmp_path):
        import sys

        log = str(tmp_path / "log.txt")
        with Logger(log):
            print("hello-tee")
            print("to-stderr", file=sys.stderr)
        content = open(log).read()
        assert "hello-tee" in content and "to-stderr" in content
        assert not isinstance(sys.stdout, Logger)

    def test_trace_profile_writes_a_chrome_trace(self, tmp_path):
        from tpufusion_torch.core import trace

        before = len(trace.PROGRAMS)
        with trace_profile(str(tmp_path / "prof")):
            torch.ones(64, 64) @ torch.ones(64, 64)
            # a program captured while it records, never replayed
            trace.PROGRAMS.append(trace.ProgramRecord())
        with open(tmp_path / "prof" / "trace.json") as f:
            assert "traceEvents" in json.load(f)
        # no step program replayed on the CPU: no replay times
        with open(tmp_path / "prof" / "replay_ms.json") as f:
            assert json.load(f) == []
        # what the profile wrote out leaves the tracer's record
        assert len(trace.PROGRAMS) == before

    def test_aggregate_loss_dict(self):
        assert aggregate_loss_dict([{"a": 1.0, "b": 2.0}, {"a": 3.0}]) == {"a": 2.0, "b": 2.0}


class TestConfigs:
    def test_iter_dict_and_choices_match_jax(self):
        assert ITER_DICT == j_configs.ITER_DICT and ITER_DICT[1024] == 100
        assert DATASET_N_DICT == {"ffhq": 5, "car": 4, "church": 3}
        assert configs.ATTACK_CHOICES == j_configs.ATTACK_CHOICES

    def test_run_postfix_schemes(self):
        cfg = AttackRunConfig(dataset_name="ffhq", lr=0.005, which_adv=[0, 1])
        jcfg = j_configs.AttackRunConfig(dataset_name="ffhq", lr=0.005, which_adv=[0, 1])
        assert cfg.run_postfix("white_box_target", 1024) == \
            "ffhq_white_box_target_100_0.00500_[0,1]"
        assert cfg.run_postfix("patch_white_box", 1024) == "ffhq_patch_white_box_2000_50_0.100"
        for attack in configs.ATTACK_CHOICES:
            assert cfg.run_postfix(attack, 32) == jcfg.run_postfix(attack, 32)

    def test_every_preset_loads_as_in_jax(self):
        import dataclasses
        import glob

        presets = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", "*.json")))
        assert len(presets) >= 5
        for p in presets:
            assert dataclasses.asdict(configs.load_config(p, seed=3)) == \
                dataclasses.asdict(j_configs.load_config(p, seed=3))

    def test_load_config_rejects_unknown_keys(self, tmp_path):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"dataset_name": "ffhq", "no_such_key": 1}))
        with pytest.raises(ValueError, match="no_such_key"):
            configs.load_config(str(bad))

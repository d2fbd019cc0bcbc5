"""Config system (copy of ``tpufusion/configs.py``) — reference C19.

Replaces the reference's scattered config surfaces with dataclasses:
- ~25 argparse flags (`attack_main2.py:848-897`, `interpolation.py:1100-1153`);
- hard-coded path dicts (`paths_config.py:1-33`);
- in-code dicts ``iter_dict = {1024:100, 512:100, 256:50}`` and
  ``dataset_n_dict = {'ffhq':5, 'car':4, 'church':3}`` (`attack_main2.py:908-909`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

ITER_DICT = {1024: 100, 512: 100, 256: 50, 64: 50, 32: 20}
DATASET_N_DICT = {"ffhq": 5, "car": 4, "church": 3}

ATTACK_CHOICES = (
    "white_box_target",
    "white_box_patch",
    "patch_white_box",
    "patch",
    "dp_noise",
    "blur",
    "out_domain_more",
    "out_domain_single",
    "adv_generate",
    "pgd",
    "pgd_classifier",
    "cw",
    "cw_classifier",
    "fgsm",
    "fusion_pgd_arith",
    "fusion_pgd_spatial",
)


@dataclasses.dataclass
class PathsConfig:
    """Checkpoint/data locations (all optional: absent -> random init)."""

    images_dir: Optional[str] = None
    save_dir: str = "runs"
    stylegan_ckpt: Optional[str] = None  # stylegan2-*-config-f.pt (g_ema)
    e4e_ckpt: Optional[str] = None  # e4e_%s_encode.pt
    vgg_ckpt: Optional[str] = None  # imagenet_vgg16.pth
    fusion_weights: Optional[str] = None  # %s_weights.json manifest
    target_image: Optional[str] = None  # vase1.png analog
    discriminator_ckpt: Optional[str] = None  # stylegan2-ada pkl (D)
    adv_inputs_path: Optional[str] = None  # precomputed adv inputs (adv_generate)
    gender_classifier_ckpt: Optional[str] = None  # face_gender_classification_256_1.pth
    car_vit_dir: Optional[str] = None  # stanford-car-vit-patch16 local dir
    # ViT serving backend: 'auto' (native unless the dir is flax-only),
    # 'native', or 'flax_hf' (transformers adapter)
    car_vit_backend: str = "auto"


@dataclasses.dataclass
class AttackRunConfig:
    """One experiment — union of the two reference drivers' flags."""

    dataset_name: str = "ffhq"
    attacks: Tuple[str, ...] = ("white_box_target",)
    batch: int = 5  # `--batch`
    n_sample: Optional[int] = 6
    align: bool = False
    seed: int = 123456789

    # data split (`--train_size/--test_size`)
    train_size: int = 2000
    test_size: int = 1000
    max_num_fusion: int = 1  # batches to evaluate (`interpolation.py:1149`)

    # white-box (`--lr`, iter_dict, `--which_adv`)
    lr: float = 1e-4
    n_iters: Optional[int] = None  # None -> ITER_DICT[generator size]
    which_adv: List[int] = dataclasses.field(default_factory=list)
    # "auto" -> stepwise when snapshots are active (streams frames to host,
    # bounded device memory), scan otherwise; explicit "scan"/"stepwise" is
    # always honoured (scan + snapshots stacks frames on device: ~3.8 GB
    # extra HBM at 1024^2 batch-8 every-5/100-iters)
    whitebox_execution: str = "auto"
    # loss preset: 'attack_main' (`attack_main2.py:649`) or 'interpolation'
    # (`interpolation.py:818`) — the two reference drivers differ here
    whitebox_preset: str = "attack_main"
    # sequential microbatch chunks per whitebox iteration (VERDICT r4 #8):
    # >1 bounds activation memory to batch/grad_accum per step so effective
    # batches beyond the single-chip ceiling run without OOM; requires the
    # stepwise executor (per-image trajectories are chunk-invariant)
    whitebox_grad_accum: int = 1

    # patch (`--epochs/--max_count/--patch_type/--patch_size`)
    epochs: int = 1
    max_count: int = 50
    patch_type: str = "square"
    patch_size: float = 0.1
    regenerate: bool = True  # False -> reuse patch_npz (`--regenerate 0`)
    patch_npz: Optional[str] = None  # precomputed patch+mask npz to reuse

    # paste / out-domain (`--paste_times`)
    paste_times: int = 3

    # dp noise (`--scale`)
    scale: float = 0.4

    # pgd/cw (torchattacks recipe, `interpolation.py:1343,1357`)
    pgd_eps: float = 8.0 / 255.0
    pgd_alpha: float = 0.01
    pgd_steps: int = 100
    cw_steps: int = 200

    # hybrid (`--hybrid_adv*`)
    hybrid_adv: bool = False
    hybrid_adv_from_existing: bool = False
    hybrid_adv_dirs: Tuple[str, ...] = ()

    use_generate_img: bool = False
    use_existing_data: bool = False
    save_img: bool = True
    # mid-run observability (VERDICT r3 ask #5): white-box image snapshots
    # every K iters under save_img (`attack_main2.py:657-661` cadence), and
    # artifact-store flush every K batches (`attack_main2.py:1096-1100`)
    snapshot_every: int = 5
    flush_every: int = 5

    # model scale knobs (not in the reference: lets tests/CI shrink models)
    image_size: Optional[int] = None
    channel_multiplier: int = 2
    encoder_base_channels: int = 64
    encoder_units: Tuple[int, ...] = (3, 4, 14, 3)

    paths: PathsConfig = dataclasses.field(default_factory=PathsConfig)

    @property
    def n_inputs(self) -> int:
        return DATASET_N_DICT[self.dataset_name]

    def iters_for(self, size: int) -> int:
        if self.n_iters is not None:
            return self.n_iters
        return ITER_DICT.get(size, 100)

    def run_postfix(self, attack: str, generator_size: int) -> str:
        """Attack-dir postfix scheme (`attack_main2.py:958-967`)."""
        ds = self.dataset_name
        if attack == "patch":
            return f"{ds}_{attack}_{self.paste_times}"
        if attack == "patch_white_box":
            return f"{ds}_{attack}_{self.train_size}_{self.max_count}_{self.patch_size:.3f}"
        if attack in ("white_box_target", "white_box_patch"):
            which = ",".join(str(i) for i in self.which_adv)
            return f"{ds}_{attack}_{self.iters_for(generator_size)}_{self.lr:.5f}_[{which}]"
        return f"{ds}_{attack}"


def load_config(path: str, **overrides) -> AttackRunConfig:
    """Load an ``AttackRunConfig`` from a JSON preset file.

    JSON keys mirror the dataclass fields; the nested ``paths`` object maps to
    :class:`PathsConfig`.  ``overrides`` (non-None values only) take precedence
    over the file, so CLI flags can refine a preset.  Presets shipped with the
    repo live in ``configs/`` (replacing the reference's hard-coded
    `paths_config.py:1-33` + argparse defaults, SURVEY §7).
    """
    import json

    with open(path) as f:
        raw = json.load(f)
    raw.pop("_comment", None)
    paths = PathsConfig(**raw.pop("paths", {}))
    field_names = {f.name for f in dataclasses.fields(AttackRunConfig)}
    unknown = set(raw) - field_names
    if unknown:
        raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
    for seq_key in ("attacks", "hybrid_adv_dirs", "encoder_units"):
        if seq_key in raw:
            raw[seq_key] = tuple(raw[seq_key])
    cfg = AttackRunConfig(paths=paths, **raw)
    for k, v in overrides.items():
        if v is None:
            continue
        if k.startswith("paths."):
            setattr(cfg.paths, k[6:], v)
        else:
            setattr(cfg, k, v)
    return cfg

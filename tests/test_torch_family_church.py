"""The church family (256^2 generator, 14 W+ rows, N = 3 inputs, resnet18
surrogate) through the port, held against the JAX package on the CPU in
float32: the family cases of ``tests/test_torch_family_car.py``, each on
this module's ``family`` fixture and oracles (a 32^2 JAX test pipeline of
church, the port on its weights). What they hold and to which tolerance is
listed there. Church leaves the FFHQ path where car does not: the encoder
input equals the generator size (no pool), no 18 -> 16 trim, three roles
reconstructed body first, 50 white-box iterations and resnet18 behind the
classifier attacks.
"""

import pytest

from tests.test_torch_family_car import (  # noqa: F401
    classifiers,
    cli_runs,
    latents,
    one_torch_thread,
    pipelines,
    test_attack_run_on_the_preset_matches_jax,
    test_classifier_for_matches_jax,
    test_generate_img_with_the_family_keywords,
    test_generator_converters_round_trip_bit_for_bit,
    test_latents_and_fused_images_match_jax,
    test_partial_benign_and_metrics_match_jax,
    test_pgd_step_and_fgsm_match_jax,
    test_run_whitebox_matches_jax,
    test_transforms_match_jax,
    test_w_plus_to_image_and_spatial_fusion_match_jax,
)


@pytest.fixture(scope="module")
def family():
    return "church"


def test_church_leaves_the_ffhq_path_where_car_does_not(pipelines):
    """The church test pipeline: pool factor 1 (``avg_pool`` the identity),
    no cars trim, three roles and 50 white-box iterations at 256^2."""
    from tpufusion_torch.configs import DATASET_N_DICT, ITER_DICT
    from tpufusion_torch.fusion.drawer import DATASET_CONFIG

    jp, tp = pipelines[:2]
    assert (tp.pool_factor, tp.is_cars, jp.is_cars) == (1, False, False)
    assert DATASET_N_DICT["church"] == 3 and ITER_DICT[256] == 50
    assert DATASET_CONFIG["church"] == dict(truncation=0.5, size=256, layers=14)

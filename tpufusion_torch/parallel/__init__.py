"""Scale-out (port of ``tpufusion/parallel``): the ``(data, model)`` mesh
over one process per device, and the sharded attacks and evaluation."""

from tpufusion_torch.parallel.sharding import (
    batch_sharding,
    create_mesh,
    expected_tp_leaf_count,
    make_sharded_group_eval,
    make_sharded_group_fusion_attack,
    make_sharded_patch_train_step,
    make_sharded_whitebox_step,
    pad_batch_to_multiple,
    replicate,
    run_cw_sharded,
    run_pgd_sharded,
    run_whitebox_sharded,
    shard_generator_params,
    train_patch_sharded,
)

__all__ = [
    "batch_sharding", "create_mesh", "expected_tp_leaf_count", "make_sharded_group_eval",
    "make_sharded_group_fusion_attack", "make_sharded_patch_train_step",
    "make_sharded_whitebox_step", "pad_batch_to_multiple", "replicate", "run_cw_sharded",
    "run_pgd_sharded", "run_whitebox_sharded", "shard_generator_params", "train_patch_sharded",
]

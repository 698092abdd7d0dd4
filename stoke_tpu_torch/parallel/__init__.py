"""Data parallelism of the port: the process group and 1-D data mesh
(:mod:`~stoke_tpu_torch.parallel.mesh`), the ZeRO ladder's placement rules
(:mod:`~stoke_tpu_torch.parallel.sharding`, with the partition rules),
their collectives (:mod:`~stoke_tpu_torch.parallel.ladder`), the
quantized gradient transports (:mod:`~stoke_tpu_torch.parallel.collectives`,
:mod:`~stoke_tpu_torch.parallel.zero`), tensor, expert and stage splits
(:mod:`~stoke_tpu_torch.parallel.tensor`) and pipeline parallelism
(:mod:`~stoke_tpu_torch.parallel.pipeline`). One process drives one
device. Counterpart of ``stoke_tpu/parallel``.
"""

from stoke_tpu_torch.parallel.ladder import Ladder
from stoke_tpu_torch.parallel.mesh import (
    build_mesh,
    initialize_distributed,
    mesh_shape,
    one_process_group,
)
from stoke_tpu_torch.parallel.pipeline import (
    Schedule,
    local_pipeline,
    pipeline,
    pipeline_with_edges,
    stack_stage_params,
    virtual_pipeline,
)
from stoke_tpu_torch.parallel.sharding import (
    ShardingRules,
    compile_partition_rules,
    leaf_partition_spec,
    make_sharding_rules,
    rule_entries,
)
from stoke_tpu_torch.parallel.tensor import (
    ModelGroup,
    TensorParallel,
    apply_partition_rules,
    copy_to_group,
    gather_from_group,
    reduce_from_group,
    shard_module,
)

__all__ = [
    "Ladder",
    "ShardingRules",
    "ModelGroup",
    "Schedule",
    "TensorParallel",
    "apply_partition_rules",
    "build_mesh",
    "compile_partition_rules",
    "copy_to_group",
    "gather_from_group",
    "initialize_distributed",
    "leaf_partition_spec",
    "local_pipeline",
    "make_sharding_rules",
    "mesh_shape",
    "one_process_group",
    "pipeline",
    "pipeline_with_edges",
    "reduce_from_group",
    "rule_entries",
    "shard_module",
    "stack_stage_params",
    "virtual_pipeline",
]

"""Data parallelism of the port: the process group and 1-D data mesh
(:mod:`~stoke_tpu_torch.parallel.mesh`), the ZeRO ladder's placement rules
(:mod:`~stoke_tpu_torch.parallel.sharding`), their collectives
(:mod:`~stoke_tpu_torch.parallel.ladder`) and the quantized gradient
transports (:mod:`~stoke_tpu_torch.parallel.collectives`,
:mod:`~stoke_tpu_torch.parallel.zero`). One process drives one device.
Counterpart of ``stoke_tpu/parallel`` less the pipeline (ROADMAP item 8).
"""

from stoke_tpu_torch.parallel.ladder import Ladder
from stoke_tpu_torch.parallel.mesh import (
    build_mesh,
    initialize_distributed,
    mesh_shape,
    one_process_group,
)
from stoke_tpu_torch.parallel.sharding import (
    ShardingRules,
    leaf_partition_spec,
    make_sharding_rules,
)

__all__ = [
    "Ladder",
    "ShardingRules",
    "build_mesh",
    "initialize_distributed",
    "leaf_partition_spec",
    "make_sharding_rules",
    "mesh_shape",
    "one_process_group",
]

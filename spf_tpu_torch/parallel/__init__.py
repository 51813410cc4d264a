"""Multi-device scaling: ciphertext-batch sharding over a device mesh
(port of `spf_tpu/parallel/`)."""

from .mesh import (  # noqa: F401
    make_mesh,
    replicate,
    shard_batch,
    shard_lanes,
    sharded_cbs,
    sharded_cbs_u32,
    sharded_pbs,
    sharded_pbs_multibit,
)
from .multihost import (  # noqa: F401
    init_distributed,
    make_multihost_mesh,
    replicate_multihost,
    scaling_model,
    shard_lanes_multihost,
    sharded_cbs_u32_multihost,
    sharded_pbs_multibit_multihost,
)

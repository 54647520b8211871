"""Parallelism on ``torch.distributed``: the rank mesh, its process groups,
the batch's row blocks, the column split of large matrices and the
collectives that the sharded steps use (ref: learnablepoolingmethods_tpu/
parallel/)."""

from learnablepoolingmethods_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    create_mesh,
    distributed_init,
    pad_batch_to_multiple,
    process_count,
    process_index,
    shard_model,
    shard_rule,
)

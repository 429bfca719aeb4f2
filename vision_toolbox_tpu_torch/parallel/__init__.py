from .mesh import (  # noqa: F401
    Mesh,
    batch_rows,
    create_mesh,
    data_parallel,
    init_process_group,
)
from .sharding import (  # noqa: F401
    fsdp_partition_spec,
    param_partition_spec,
    partition_specs,
    shard_train_state,
)

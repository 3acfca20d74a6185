"""Data parallelism over ``torch.distributed``: one process per card (the
port of the JAX package's ``parallel/``).

Not ported: ``packed_replicate`` (one transfer per dtype through a remote TPU
link), ``batch_sharding`` and ``replicated`` (XLA sharding annotations).
"""

from .distributed import (
    distributed_env_requested,
    local_ranks,
    maybe_init_distributed,
    process_local_batch_slice,
    rank_device,
    shutdown_distributed,
)
from .mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_gradients,
    all_reduce_sum,
    barrier,
    create_mesh,
    global_replicate,
    global_shard,
    is_main_process,
    main_rank_first,
    replicate,
    shard_batch,
)

"""The sharded runtime: partitions of one mesh solved together, one
worker thread per partition (port of orc_tpu/parallel)."""

from orc_tpu_torch.parallel.partition import (  # noqa: F401
    Partition,
    partition_mesh,
    rcb_partition,
)
from orc_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedComm,
    gather_state,
    make_sharded_step,
    scatter_state,
    solve_steady_sharded,
)

"""Data parallelism: ranks (distributed.py) and replica sets (mesh.py).

The JAX package's names, less ``make_global_batch``: each rank keeps its
own rows of a batch (parallel/distributed.py). Plus ``replicated_forward``
(one forward per device of a replica set) and ``rank_device``.
"""

from crosstalk_tpu_torch.parallel.distributed import (
    allgather_to_host,
    initialize,
    is_primary,
    process_row_slice,
    rank_device,
)
from crosstalk_tpu_torch.parallel.mesh import (
    data_mesh,
    maybe_data_mesh,
    replicated_forward,
)

__all__ = [
    "data_mesh",
    "maybe_data_mesh",
    "replicated_forward",
    "initialize",
    "is_primary",
    "process_row_slice",
    "allgather_to_host",
    "rank_device",
]

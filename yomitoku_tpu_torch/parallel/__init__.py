"""Data parallelism over devices (the port's counterpart of
yomitoku_tpu/parallel/): meshes and placements (``mesh``), replicas and
the data-parallel runner (``runner``).  The tensor-parallel pair
(``parseq_param_shardings``, ``shard_params``) is not ported yet."""

from .mesh import (  # noqa: F401
    batch_sharding,
    dp_mesh,
    make_mesh,
    replicated,
    shard_batch,
)
from .runner import DataParallel, dp_pages  # noqa: F401

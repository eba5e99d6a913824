"""Parallelism over devices (the port's counterpart of
yomitoku_tpu/parallel/): meshes, placements and the tensor-parallel rule
for PARSeq's vocabulary (``mesh``), replicas and the data-parallel runner
(``runner``), and the tensor-parallel rows that ``shard_params`` builds
(``tensor_parallel``)."""

from .mesh import (  # noqa: F401
    batch_sharding,
    dp_mesh,
    make_mesh,
    parseq_param_shardings,
    replicated,
    shard_batch,
    shard_params,
)
from .runner import DataParallel, dp_pages  # noqa: F401

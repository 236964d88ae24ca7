"""Data parallelism over ``torch.distributed`` — port of ``usv_tpu/parallel``.

One process per rank, each holding its share of the env batch and of the
replay and a replicated learner; see :mod:`usv_tpu_torch.parallel.mesh`.
"""

from usv_tpu_torch.parallel.mesh import (
    EnvMesh,
    make_env_mesh,
    shard_env_batch,
    replicate,
)
from usv_tpu_torch.parallel.dist import initialize_distributed, fold_host_key

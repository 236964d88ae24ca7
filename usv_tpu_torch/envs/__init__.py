"""The env families as batch-first functional cores (``usv-simple``,
``usv-asmc-simple``, ``usv-aitsmc-simple``, ``usv-asmc-ca-v0``,
``usv-curved-aitsmc`` and the legacy ``usv-asmc-v0``, ``usv-pid-v0``,
``usv-asmc-ye-int-v0``), the full-width auto-reset and the registry
(``make``, ``register``, ``registered_ids``)."""

from usv_tpu_torch.envs.types import TimeStep
from usv_tpu_torch.envs.registry import EnvHandle, make, register, registered_ids
from usv_tpu_torch.envs.autoreset import make_autoreset_step

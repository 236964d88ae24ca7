from usv_tpu_torch.envs.types import TimeStep
from usv_tpu_torch.envs.registry import EnvHandle, make, registered_ids
from usv_tpu_torch.envs.autoreset import make_autoreset_step

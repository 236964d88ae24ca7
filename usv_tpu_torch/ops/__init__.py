"""The ray-cast sensor: the plain PyTorch form, the CUDA kernel's launcher
(``raycast_cuda``) and the backend dispatch the envs call."""

from usv_tpu_torch.ops.raycast import (
    raycast,
    raycast_first_hit_compat,
    sensor_angles,
)

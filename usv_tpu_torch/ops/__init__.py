from usv_tpu_torch.ops.raycast import (
    raycast,
    raycast_first_hit_compat,
    sensor_angles,
)

"""The ray-cast sensor: the plain PyTorch form, the CUDA kernel's launcher
(``raycast_cuda``) and the backend dispatch the envs call; and the substep
kernels' launchers, ``asmc_cuda`` and ``aitsmc_cuda``, which
``control/asmc.py`` and ``control/aitsmc.py`` call, and what the four share
(``_substeps``)."""

from usv_tpu_torch.ops.raycast import (
    raycast,
    raycast_first_hit_compat,
    sensor_angles,
)

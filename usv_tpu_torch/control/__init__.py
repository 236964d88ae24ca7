"""Inner-loop controllers (ASMC, AITSMC, PID) and the substep runner."""

from usv_tpu_torch.control.aitsmc import (
    AitsmcGains,
    AitsmcLoopState,
    AitsmcSetpoint,
    AitsmcState,
    aitsmc_compute,
    aitsmc_control,
    init_aitsmc,
)
from usv_tpu_torch.control.asmc import (
    AsmcGains,
    AsmcLoopState,
    AsmcState,
    asmc_compute,
    asmc_control,
    init_asmc,
    init_asmc_loop,
)
from usv_tpu_torch.control.pid import (
    PidGains,
    PidLoopState,
    PidState,
    init_pid,
    pid_compute,
    pid_control,
)
from usv_tpu_torch.control.runner import run_controller_and_model

"""Generic controller+model substep runner — port of
``usv_tpu/control/runner.py``.

The counterpart of the C++ ``update_controller_and_model_n``: N substeps of
{controller -> dynamics integrate}, returning the final states and the full
per-substep history. The history is this function's purpose (the reference's
``model_history`` and ``controller_history`` lists), so it is always built,
stacked to ``(B, n_substeps, ...)`` with the batch first.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

from usv_tpu_torch.control.asmc import stack_history
from usv_tpu_torch.physics.dynamics import DynamicsState, dynamics_step
from usv_tpu_torch.physics.params import VehicleParams

# control_fn(ctrl_state, dyn_state) -> (ctrl_state, tport, tstbd, debug)
ControlFn = Callable[[Any, DynamicsState], Tuple[Any, Any, Any, Any]]


def run_controller_and_model(
    control_fn: ControlFn,
    vparams: VehicleParams,
    ctrl_state,
    dyn_state: DynamicsState,
    n_substeps: int,
    dt: float = 0.01,
):
    """Returns (ctrl_state, dyn_state, model_history, controller_history)."""
    model_records, controller_records = [], []
    for _ in range(n_substeps):
        ctrl_state, tport, tstbd, debug = control_fn(ctrl_state, dyn_state)
        dyn_state = dynamics_step(vparams, dyn_state, tport, tstbd, dt)
        model_records.append({"pose": dyn_state.pose, "vel": dyn_state.vel})
        controller_records.append(debug)
    return (ctrl_state, dyn_state, stack_history(model_records),
            stack_history(controller_records))

"""Vehicle physics: the model's coefficients and the Fossen 3-DOF dynamics."""

from usv_tpu_torch.physics.dynamics import (
    DynamicsState,
    dynamics_step,
    fossen_acceleration,
    hydrodynamic_coefficients,
    init_dynamics,
    perturbation_force,
    surge_yaw_model_terms,
    thruster_allocation,
)
from usv_tpu_torch.physics.params import VehicleParams

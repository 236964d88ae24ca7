"""PID surge-speed + heading controller — port of ``usv_tpu/control/pid.py``.

Semantics kept from the JAX module (reference ``control/usv_pid.py:55-213``):
the sideslip-compensated, atan2-wrapped heading setpoint, the heading error
through the atan2 wrap, ``e_psi_dot = -r`` (no reference filter), the
trapezoidal integral and backward-difference derivative of the speed error,
the thruster clip to +-30, the perturbation force computed by the reference
but never applied (so never applied here), and ``e_u_last`` never being
written back (the ``freeze_e_u_last`` compat flag, default on).
"""

from __future__ import annotations

import dataclasses

import torch

from usv_tpu_torch.control.asmc import stack_history
from usv_tpu_torch.core.angles import wrap_angle
from usv_tpu_torch.physics.dynamics import (
    DynamicsState,
    dynamics_step,
    surge_yaw_model_terms,
)
from usv_tpu_torch.physics.params import VehicleParams


@dataclasses.dataclass(frozen=True)
class PidGains:
    """Defaults per reference control/usv_pid.py:27-31."""

    kp_u: float = 1.6
    ki_u: float = 0.2
    kd_u: float = 0.1
    kp_psi: float = 22.625
    kd_psi: float = 10.0
    thrust_limit: float = 30.0
    # Reference quirk: e_u_last is never written back (see module docstring).
    freeze_e_u_last: bool = True


@dataclasses.dataclass(frozen=True)
class PidState:
    e_u_last: torch.Tensor
    e_u_int: torch.Tensor

    def replace(self, **changes) -> "PidState":
        return dataclasses.replace(self, **changes)


def init_pid(batch_shape=(), dtype=torch.float32, device="cpu") -> PidState:
    z = torch.zeros(tuple(batch_shape), dtype=dtype, device=device)
    return PidState(e_u_last=z, e_u_int=z)


def pid_control(
    gains: PidGains,
    vparams: VehicleParams,
    state: PidState,
    u_d,
    heading_offset,
    pose,
    vel,
    dt=0.01,
):
    """One 100 Hz PID update -> (state, tport, tstbd, debug)."""
    u, v, r = vel[..., 0], vel[..., 1], vel[..., 2]
    psi = pose[..., 2]

    beta = torch.asin(v / (0.001 + torch.hypot(u, v)))
    psi_d = wrap_angle(psi + heading_offset + beta)

    f_u, f_psi, g_u, g_psi = surge_yaw_model_terms(vparams, u, v, r)

    e_psi = wrap_angle(psi_d - psi)
    e_psi_dot = -r

    e_u = u_d - u
    e_u_int = 0.5 * dt * (e_u + state.e_u_last) + state.e_u_int
    e_u_dot = (e_u - state.e_u_last) / dt

    ua_u = gains.kp_u * e_u + gains.ki_u * e_u_int + gains.kd_u * e_u_dot
    ua_psi = gains.kp_psi * e_psi + gains.kd_psi * e_psi_dot

    tx = (-f_u + ua_u) / g_u
    tz = (-f_psi + ua_psi) / g_psi

    tport = torch.clamp(tx / 2.0 + tz / vparams.B, -gains.thrust_limit, gains.thrust_limit)
    tstbd = torch.clamp(
        tx / (2.0 * vparams.c) - tz / (vparams.B * vparams.c),
        -gains.thrust_limit,
        gains.thrust_limit,
    )

    new_e_u_last = state.e_u_last if gains.freeze_e_u_last else e_u
    new_state = PidState(e_u_last=new_e_u_last, e_u_int=e_u_int)
    debug = {
        "psi_d": psi_d, "e_psi": e_psi, "e_u": e_u, "u_d": u_d,
        "tport": tport, "tstbd": tstbd,
    }
    return new_state, tport, tstbd, debug


@dataclasses.dataclass(frozen=True)
class PidLoopState:
    ctrl: PidState
    dyn: DynamicsState
    perturb_step: torch.Tensor  # (B,) int32

    def replace(self, **changes) -> "PidLoopState":
        return dataclasses.replace(self, **changes)


def pid_compute(
    gains: PidGains,
    vparams: VehicleParams,
    loop: PidLoopState,
    action,
    do_perturb=False,  # kept for API symmetry; the reference never applies it
    n_substeps: int = 10,
    dt: float = 0.01,
    keep_history: bool = False,
):
    """N substeps of {PID -> dynamics} — reference ``UsvPID.compute`` (:55-213).
    Returns ``(loop, last, history)`` as ``asmc_compute`` does."""
    del do_perturb  # the reference computes but never applies the force (:167)
    u_d = action[..., 0]
    heading_offset = action[..., 1]

    ctrl, dyn = loop.ctrl, loop.dyn
    records = []
    last = None
    for _ in range(n_substeps):
        ctrl, tport, tstbd, last = pid_control(
            gains, vparams, ctrl, u_d, heading_offset, dyn.pose, dyn.vel, dt
        )
        dyn = dynamics_step(vparams, dyn, tport, tstbd, dt)
        if keep_history:
            records.append(last)
    new = PidLoopState(ctrl=ctrl, dyn=dyn, perturb_step=loop.perturb_step + n_substeps)
    return new, last, (stack_history(records) if keep_history else None)

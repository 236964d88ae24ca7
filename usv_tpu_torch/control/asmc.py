"""Adaptive sliding-mode controller (ASMC) for surge speed + heading — port of
``usv_tpu/control/asmc.py``.

The controller is a pure function ``(gains, vparams, state, setpoints, pose,
vel) -> (state, tport, tstbd, debug)`` over ``(B,)`` tensors; the combined
controller+dynamics substep loop (:func:`asmc_compute`) is a Python loop
where JAX has a ``lax.scan``.

Semantics kept from the JAX module (reference ``control/usv_asmc.py:53-244``):
the sideslip-compensated heading setpoint, the second-order reference filter
producing r_d, the single-branch heading-error wrap in offset mode and the
total wrap in absolute mode, the adaptive gain law with dead zone mu and
floor kmin, the sqrt-sigma reaching law, the unsaturated thruster mixing, and
the perturbation counter advancing once per substep.
"""

from __future__ import annotations

import dataclasses

import torch

from usv_tpu_torch.core.angles import wrap_angle, wrap_angle_once
from usv_tpu_torch.physics.dynamics import (
    DynamicsState,
    dynamics_step,
    init_dynamics,
    perturbation_force,
    surge_yaw_model_terms,
)
from usv_tpu_torch.physics.params import VehicleParams
from usv_tpu_torch.timing import span


@dataclasses.dataclass(frozen=True)
class AsmcGains:
    """ASMC gains; defaults per reference control/usv_asmc.py:26-41."""

    k_u: float = 0.1
    k_psi: float = 0.2
    kmin_u: float = 0.05
    kmin_psi: float = 0.2
    k2_u: float = 0.02
    k2_psi: float = 0.1
    mu_u: float = 0.05
    mu_psi: float = 0.1
    lambda_u: float = 0.001
    lambda_psi: float = 1.0
    # Second-order reference filter (r_d) coefficients
    f1: float = 2.0
    f2: float = 2.0
    f3: float = 2.0


@dataclasses.dataclass(frozen=True)
class AsmcState:
    """Controller memory: reference filter, integrators, adaptive gains; each
    field a ``(B,)`` tensor."""

    psi_d_last: torch.Tensor
    o: torch.Tensor
    o_dot: torch.Tensor
    o_dot_dot_last: torch.Tensor
    e_u_last: torch.Tensor
    e_u_int: torch.Tensor
    ka_u: torch.Tensor
    ka_psi: torch.Tensor
    ka_dot_u_last: torch.Tensor
    ka_dot_psi_last: torch.Tensor

    def replace(self, **changes) -> "AsmcState":
        return dataclasses.replace(self, **changes)


def init_asmc(batch_shape=(), dtype=torch.float32, device="cpu") -> AsmcState:
    z = torch.zeros(tuple(batch_shape), dtype=dtype, device=device)
    return AsmcState(**{f.name: z for f in dataclasses.fields(AsmcState)})


def asmc_control(
    gains: AsmcGains,
    vparams: VehicleParams,
    state: AsmcState,
    u_d,
    heading_offset,
    pose,
    vel,
    dt=0.01,
    absolute_heading: bool = False,
):
    """One 100 Hz control update: returns (state, tport, tstbd, debug dict).

    ``u_d`` is the surge-speed setpoint and ``heading_offset`` the
    course-offset setpoint added to the sideslip-compensated course. With
    ``absolute_heading`` the setpoint is a world-frame heading instead (the
    contract of the collision-avoidance env, whose action denormalizes to an
    absolute angle in [-pi, pi]).
    """
    u, v, r = vel[..., 0], vel[..., 1], vel[..., 2]
    psi = pose[..., 2]

    if absolute_heading:
        psi_d = heading_offset
        if not torch.is_tensor(psi_d):
            psi_d = torch.full_like(psi, psi_d)
    else:
        # Sideslip-compensated desired heading (reference :72-77)
        beta = torch.asin(v / (0.001 + torch.hypot(u, v)))
        psi_d = psi + beta + heading_offset

    # Second-order filter for the desired yaw rate r_d (reference :84-92). In
    # absolute mode the setpoint lives on the circle: wrap the finite
    # difference, or a setpoint crossing the +-pi seam injects a ~2*pi/dt
    # spike into the desired yaw rate.
    psi_d_diff = psi_d - state.psi_d_last
    if absolute_heading:
        psi_d_diff = wrap_angle(psi_d_diff)
    r_d_raw = psi_d_diff / dt
    o_dot_dot = ((r_d_raw - state.o) * gains.f1 - gains.f3 * state.o_dot) * gains.f2
    o_dot = 0.5 * dt * (o_dot_dot + state.o_dot_dot_last) + state.o_dot
    o = 0.5 * dt * (o_dot + state.o_dot) + state.o
    r_d = o

    # Simplified surge/yaw model terms f, g (reference :110-116)
    f_u, f_psi, g_u, g_psi = surge_yaw_model_terms(vparams, u, v, r)

    # Errors (reference :119-129). In absolute mode psi is unbounded (nothing
    # wraps the dynamics' pose), so the total atan2 wrap is required.
    if absolute_heading:
        e_psi = wrap_angle(psi_d - psi)
    else:
        e_psi = wrap_angle_once(psi_d - psi)
    e_psi_dot = r_d - r
    e_u = u_d - u
    e_u_int = 0.5 * dt * (e_u + state.e_u_last) + state.e_u_int

    # Sliding surfaces (reference :133-134)
    sigma_u = e_u + gains.lambda_u * e_u_int
    sigma_psi = e_psi_dot + gains.lambda_psi * e_psi

    # Adaptive gain law (reference :137-147)
    ka_dot_u = torch.where(
        state.ka_u > gains.kmin_u,
        gains.k_u * torch.sign(torch.abs(sigma_u) - gains.mu_u),
        gains.kmin_u,
    )
    ka_dot_psi = torch.where(
        state.ka_psi > gains.kmin_psi,
        gains.k_psi * torch.sign(torch.abs(sigma_psi) - gains.mu_psi),
        gains.kmin_psi,
    )
    ka_u = 0.5 * dt * (ka_dot_u + state.ka_dot_u_last) + state.ka_u
    ka_psi = 0.5 * dt * (ka_dot_psi + state.ka_dot_psi_last) + state.ka_psi

    # Reaching law + equivalent control (reference :150-155)
    ua_u = -ka_u * torch.sqrt(torch.abs(sigma_u)) * torch.sign(sigma_u) - gains.k2_u * sigma_u
    ua_psi = (
        -ka_psi * torch.sqrt(torch.abs(sigma_psi)) * torch.sign(sigma_psi)
        - gains.k2_psi * sigma_psi
    )
    tx = (gains.lambda_u * e_u - f_u - ua_u) / g_u
    tz = (gains.lambda_psi * e_psi - f_psi - ua_psi) / g_psi

    # Thruster mixing — unsaturated, as in the reference (:158-162)
    tport = tx / 2.0 + tz / vparams.B
    tstbd = tx / (2.0 * vparams.c) - tz / (vparams.B * vparams.c)

    new_state = AsmcState(
        psi_d_last=psi_d,
        o=o, o_dot=o_dot, o_dot_dot_last=o_dot_dot,
        e_u_last=e_u, e_u_int=e_u_int,
        ka_u=ka_u, ka_psi=ka_psi,
        ka_dot_u_last=ka_dot_u, ka_dot_psi_last=ka_dot_psi,
    )
    debug = {
        "psi_d": psi_d, "u_d": u_d, "e_u": e_u, "e_psi": e_psi,
        "sigma_u": sigma_u, "sigma_psi": sigma_psi,
        "ka_u": ka_u, "ka_psi": ka_psi,
        "tport": tport, "tstbd": tstbd, "tx": tx, "tz": tz,
    }
    return new_state, tport, tstbd, debug


@dataclasses.dataclass(frozen=True)
class AsmcLoopState:
    """Combined controller + vehicle state for the substep loop."""

    ctrl: AsmcState
    dyn: DynamicsState
    perturb_step: torch.Tensor  # (B,) int32; advances once per substep

    def replace(self, **changes) -> "AsmcLoopState":
        return dataclasses.replace(self, **changes)


def init_asmc_loop(x=0.0, y=0.0, psi=0.0, batch_shape=(), dtype=torch.float32,
                   device="cpu") -> AsmcLoopState:
    return AsmcLoopState(
        ctrl=init_asmc(batch_shape, dtype=dtype, device=device),
        dyn=init_dynamics(x, y, psi, batch_shape, dtype=dtype, device=device),
        perturb_step=torch.zeros(tuple(batch_shape), dtype=torch.int32, device=device),
    )


def stack_history(records):
    """A list of per-substep dicts of ``(B, ...)`` tensors as one dict of
    ``(B, n_substeps, ...)`` tensors: the batch stays the first dimension."""
    return {k: torch.stack([rec[k] for rec in records], dim=1) for k in records[0]}


def asmc_compute(
    gains: AsmcGains,
    vparams: VehicleParams,
    loop: AsmcLoopState,
    action,
    do_perturb=False,
    n_substeps: int = 10,
    dt: float = 0.01,
    perturb_freq: float = 10.0,
    perturb_magnitude: float = 5.0,
    absolute_heading: bool = False,
    unroll: int = 1,
    keep_history: bool = False,
):
    """N substeps of {ASMC @100 Hz -> dynamics integrate} — ``UsvAsmc.compute``
    (reference control/usv_asmc.py:53-244).

    ``action`` is ``(B, 2)`` = (u_d, heading setpoint). Returns ``(loop, last,
    history)``: the advanced loop state, the last substep's debug dict (with
    the post-integration ``pose`` and ``vel``), and, with ``keep_history``,
    every substep's dict stacked to ``(B, n_substeps, ...)``, else ``None``.
    JAX returns the whole history from its scan and lets the compiler drop
    what no caller reads; eager PyTorch drops nothing, so the history is
    built only on request. ``unroll`` is the scan's unroll factor there; a
    Python loop has none, and the argument is accepted and ignored.
    """
    del unroll
    u_d = action[..., 0]
    heading_offset = action[..., 1]

    ctrl, dyn = loop.ctrl, loop.dyn
    records = []
    last = None
    with span("usv.env.substeps"):
        for i in range(n_substeps):
            ctrl, tport, tstbd, debug = asmc_control(
                gains, vparams, ctrl, u_d, heading_offset, dyn.pose, dyn.vel, dt,
                absolute_heading=absolute_heading,
            )
            if do_perturb:
                px, py = perturbation_force(
                    dyn.pose[..., 2], (loop.perturb_step + i).to(torch.float32),
                    dt, perturb_freq, perturb_magnitude,
                )
            else:
                px = py = 0.0
            dyn = dynamics_step(vparams, dyn, tport, tstbd, dt, px, py)
            last = {**debug, "pose": dyn.pose, "vel": dyn.vel}
            if keep_history:
                records.append(last)
    new = AsmcLoopState(ctrl=ctrl, dyn=dyn, perturb_step=loop.perturb_step + n_substeps)
    return new, last, (stack_history(records) if keep_history else None)

"""Fossen 3-DOF surface-vessel dynamics — port of ``usv_tpu/physics/dynamics.py``.

The mass matrix has a fixed sparsity (surge decoupled; sway/yaw 2x2 block),
so M^-1 is applied in closed form and the Coriolis and damping products are
written component-wise: every line is one elementwise tensor op over the env
batch. The state is an explicit dataclass of ``(B, 3)`` tensors and the model
a pure function of it.

Semantics kept from the JAX module (and through it from the reference's
``control/usv_asmc.py:94-235``): the speed-dependent Xu/Xuu switch at
|u| > 1.2, the speed-dependent Yv/Yr/Nv/Nr, the CA terms that multiply
``X_u_dot`` by ``m``, trapezoidal integration of nu and then of eta, the
thruster mixing and the sinusoidal perturbation force rotated into the body
frame. Products associate as in the JAX source, Python scalars first where
they stand first there, so float32 results round alike.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from usv_tpu_torch.physics.params import VehicleParams


@dataclasses.dataclass(frozen=True)
class DynamicsState:
    """Pose, body velocity, and the previous derivatives for the trapezoid rule.

    pose         : (B, 3)  x, y, psi            (NED position + heading)
    vel          : (B, 3)  u, v, r              (body-frame velocities)
    accel_last   : (B, 3)  previous nu_dot
    eta_dot_last : (B, 3)  previous eta_dot
    """

    pose: torch.Tensor
    vel: torch.Tensor
    accel_last: torch.Tensor
    eta_dot_last: torch.Tensor

    def replace(self, **changes) -> "DynamicsState":
        return dataclasses.replace(self, **changes)


def init_dynamics(x=0.0, y=0.0, psi=0.0, batch_shape=(), dtype=torch.float32,
                  device="cpu") -> DynamicsState:
    """Fresh model at a pose, zero velocity, broadcast to ``batch_shape``."""
    shape = tuple(batch_shape) + (3,)
    pose = torch.tensor([x, y, psi], dtype=dtype, device=device).expand(shape).clone()
    z = torch.zeros(shape, dtype=dtype, device=device)
    return DynamicsState(pose=pose, vel=z, accel_last=z, eta_dot_last=z)


# Constant factor in Yv (reference control/usv_asmc.py:101-102): the bracketed
# hull-form expression is state-independent.
_YV_FORM_FACTOR = 1.1 + 0.0045 * (1.01 / 0.09) - 0.1 * (0.27 / 0.09) + 0.016 * (
    (0.27 / 0.09) ** 2
)
# The reference spells pi as 3.141592 (control/usv_asmc.py:103-108).
_REF_PI = 3.141592


def hydrodynamic_coefficients(u, v):
    """Speed-dependent linear damping terms (Xu, Xuu, Yv, Yr, Nv, Nr) —
    reference control/usv_asmc.py:94-108."""
    fast = torch.abs(u) > 1.2
    Xu = torch.where(fast, 64.55, -25.0)
    Xuu = torch.where(fast, -70.92, 0.0)

    speed = torch.sqrt(u * u + v * v)
    Yv = 0.5 * (-40.0 * 1000.0 * torch.abs(v)) * _YV_FORM_FACTOR
    Yr = 6.0 * (-_REF_PI * 1000.0) * speed * 0.09 * 0.09 * 1.01
    Nv = 0.06 * (-_REF_PI * 1000.0) * speed * 0.09 * 0.09 * 1.01
    Nr = 0.02 * (-_REF_PI * 1000.0) * speed * 0.09 * 0.09 * 1.01 * 1.01
    return Xu, Xuu, Yv, Yr, Nv, Nr


def surge_yaw_model_terms(params: VehicleParams, u, v, r):
    """Simplified surge/yaw model (f_u, f_psi, g_u, g_psi) shared by every
    inner-loop controller (reference control/usv_asmc.py:110-116). ``g_u``
    and ``g_psi`` are Python floats."""
    Xu, Xuu, _, _, _, Nr = hydrodynamic_coefficients(u, v)
    g_u = 1.0 / (params.m - params.X_u_dot)
    g_psi = 1.0 / (params.Iz - params.N_r_dot)
    f_u = ((params.m - params.Y_v_dot) * v * r + (Xuu * torch.abs(u) + Xu * u)) * g_u
    f_psi = ((-params.X_u_dot + params.Y_v_dot) * u * v + Nr * r) * g_psi
    return f_u, f_psi, g_u, g_psi


def thruster_allocation(params: VehicleParams, tport, tstbd):
    """Port/starboard thrusts -> generalized force (Tx, Tz) — reference :176."""
    tx = tport + params.c * tstbd
    tz = 0.5 * params.B * (tport - params.c * tstbd)
    return tx, tz


def fossen_acceleration(params: VehicleParams, vel, tau_x, tau_y, tau_z):
    """nu_dot = M^-1 (tau - C(nu) nu - D(nu) nu), component-wise — the math of
    reference control/usv_asmc.py:201-227 with M^-1 in closed form. The CA
    entries that read ``X_u_dot * m * u`` are the reference's own."""
    u, v, r = vel[..., 0], vel[..., 1], vel[..., 2]
    Xu, Xuu, Yv, Yr, Nv, Nr = hydrodynamic_coefficients(u, v)

    # C(nu) nu  (CRB + CA; reference :201-211)
    c13 = -params.m * v + 2.0 * (
        params.Y_v_dot * v + 0.5 * (params.Y_r_dot + params.N_v_dot) * r
    )
    c23 = params.m * u - params.X_u_dot * params.m * u
    c31 = params.m * v + 2.0 * (
        -params.Y_v_dot * v - 0.5 * (params.Y_r_dot + params.N_v_dot) * r
    )
    c32 = -params.m * u + params.X_u_dot * params.m * u

    # D(nu) nu  (Dl - Dn; reference :213-223)
    abs_u, abs_v, abs_r = torch.abs(u), torch.abs(v), torch.abs(r)
    d11 = -Xu - Xuu * abs_u
    d22 = -Yv - (params.Yvv * abs_v + params.Yvr * abs_r)
    d23 = -Yr - (params.Yrv * abs_v + params.Yrr * abs_r)
    d32 = -Nv - (params.Nvv * abs_v + params.Nvr * abs_r)
    d33 = -Nr - (params.Nrv * abs_v + params.Nrr * abs_r)

    rhs_u = tau_x - c13 * r - d11 * u
    rhs_v = tau_y - c23 * r - (d22 * v + d23 * r)
    rhs_r = tau_z - (c31 * u + c32 * v) - (d32 * v + d33 * r)

    # Closed-form M^-1
    inv_m11 = 1.0 / params.m11
    det = params.m22 * params.m33 - params.m23 * params.m32
    a_u = rhs_u * inv_m11
    a_v = (params.m33 * rhs_v - params.m23 * rhs_r) / det
    a_r = (params.m22 * rhs_r - params.m32 * rhs_v) / det
    return torch.stack([a_u, a_v, a_r], dim=-1)


def perturbation_force(psi, perturb_step, dt, freq, magnitude):
    """Sinusoidal disturbance force, world frame rotated into the body frame
    (reference control/usv_asmc.py:184-198). ``perturb_step`` is a float
    tensor. Returns the body-frame (x, y) force."""
    t = perturb_step * dt
    k = freq * (2.0 * math.pi)
    fx = torch.cos(t * k) * magnitude
    fy = torch.cos(t + k + 10.0) * magnitude
    c, s = torch.cos(psi), torch.sin(psi)
    # row-vector @ J == J^T [fx, fy, 0]
    return c * fx + s * fy, -s * fx + c * fy


def _is_zero(x) -> bool:
    return isinstance(x, (int, float)) and x == 0


def dynamics_step(
    params: VehicleParams,
    state: DynamicsState,
    tport,
    tstbd,
    dt,
    perturb_x=0.0,
    perturb_y=0.0,
    perturb_z=0.0,
) -> DynamicsState:
    """One integration substep (default 100 Hz): thrust -> accel -> trapezoid
    (reference control/usv_asmc.py:172-235). ``perturb_*`` is an additional
    body-frame generalized force; a Python zero adds nothing and is skipped.
    """
    tau_x, tau_z = thruster_allocation(params, tport, tstbd)
    tau_y = torch.zeros_like(tau_x)
    if not _is_zero(perturb_x):
        tau_x = tau_x + perturb_x
    if not _is_zero(perturb_y):
        tau_y = tau_y + perturb_y
    if not _is_zero(perturb_z):
        tau_z = tau_z + perturb_z

    accel = fossen_acceleration(params, state.vel, tau_x, tau_y, tau_z)
    vel = state.vel + 0.5 * dt * (accel + state.accel_last)

    psi = state.pose[..., 2]
    c, s = torch.cos(psi), torch.sin(psi)
    u, v, r = vel[..., 0], vel[..., 1], vel[..., 2]
    eta_dot = torch.stack([c * u - s * v, s * u + c * v, r], dim=-1)
    pose = state.pose + 0.5 * dt * (eta_dot + state.eta_dot_last)

    return DynamicsState(pose=pose, vel=vel, accel_last=accel, eta_dot_last=eta_dot)

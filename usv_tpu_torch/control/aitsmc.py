"""AITSMC — adaptive integral terminal sliding-mode controller (u, r channels)
— port of ``usv_tpu/control/aitsmc.py``.

The control law is the JAX module's reconstruction of the reference's C++
``AITSMC``: per-channel adaptive gains Ka with dead zone mu and floor kmin,
integral-terminal sliding surfaces, the shared surge/yaw model terms and
thruster allocation, and an asymmetric thruster clip.
"""

from __future__ import annotations

import dataclasses

import torch

from usv_tpu_torch.control.asmc import stack_history
from usv_tpu_torch.physics.dynamics import (
    DynamicsState,
    dynamics_step,
    surge_yaw_model_terms,
)
from usv_tpu_torch.physics.params import VehicleParams
from usv_tpu_torch.timing import span


def _sig_pow(x, p):
    """|x|^p * sign(x) — the 'sig' function of terminal SMC papers. ``pow``
    as in the JAX module; at the default p = 0.5 both PyTorch and XLA take
    the square root for it."""
    return torch.pow(torch.abs(x), p) * torch.sign(x)


@dataclasses.dataclass(frozen=True)
class AitsmcGains:
    """Adaptation and surface gains; the C++ ``AITSMC.defaultParams()`` analog."""

    # adaptation rates
    k_u: float = 0.1
    k_r: float = 0.2
    # adaptive-gain floors
    kmin_u: float = 0.05
    kmin_r: float = 0.05
    # dead-zone half-widths on |sigma|
    mu_u: float = 0.05
    mu_r: float = 0.1
    # linear reaching terms
    k2_u: float = 0.02
    k2_r: float = 0.1
    # integral-terminal surface weights and exponent
    lambda_u: float = 0.1
    lambda_r: float = 0.1
    beta: float = 0.5
    # thruster saturation (asymmetric, per the published USV hardware limits)
    t_min: float = -30.0
    t_max: float = 36.5


@dataclasses.dataclass(frozen=True)
class AitsmcSetpoint:
    """{u, r, dot_u, dot_r} — mirror of ``AITSMCSetpoint``; ``(B,)`` tensors
    or Python floats."""

    u: torch.Tensor
    r: torch.Tensor
    dot_u: torch.Tensor
    dot_r: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AitsmcState:
    e_u_int: torch.Tensor  # integral of sig(e_u)^beta
    e_r_int: torch.Tensor  # integral of sig(e_r)^beta
    e_u_last: torch.Tensor
    e_r_last: torch.Tensor
    ka_u: torch.Tensor
    ka_r: torch.Tensor
    ka_dot_u_last: torch.Tensor
    ka_dot_r_last: torch.Tensor

    # the C++ getDebugData() exposed the last errors as (e_u, e_r, Ka_u,
    # Ka_r); e_u_last/e_r_last hold exactly those values after each update
    @property
    def e_u(self):
        return self.e_u_last

    @property
    def e_r(self):
        return self.e_r_last

    def replace(self, **changes) -> "AitsmcState":
        return dataclasses.replace(self, **changes)


def init_aitsmc(batch_shape=(), dtype=torch.float32, device="cpu") -> AitsmcState:
    z = torch.zeros(tuple(batch_shape), dtype=dtype, device=device)
    return AitsmcState(**{f.name: z for f in dataclasses.fields(AitsmcState)})


def aitsmc_control(
    gains: AitsmcGains,
    vparams: VehicleParams,
    state: AitsmcState,
    setpoint: AitsmcSetpoint,
    vel,
    dt=0.01,
):
    """One 100 Hz AITSMC update -> (state, tport, tstbd, debug)."""
    u, v, r = vel[..., 0], vel[..., 1], vel[..., 2]

    f_u, f_r, g_u, g_r = surge_yaw_model_terms(vparams, u, v, r)

    # Tracking errors
    e_u = setpoint.u - u
    e_r = setpoint.r - r

    # Integral-terminal sliding surfaces:
    #   sigma = e + lambda * int sig(e)^beta dtau   (trapezoidal integral)
    sig_e_u = _sig_pow(e_u, gains.beta)
    sig_e_r = _sig_pow(e_r, gains.beta)
    e_u_int = 0.5 * dt * (sig_e_u + _sig_pow(state.e_u_last, gains.beta)) + state.e_u_int
    e_r_int = 0.5 * dt * (sig_e_r + _sig_pow(state.e_r_last, gains.beta)) + state.e_r_int
    sigma_u = e_u + gains.lambda_u * e_u_int
    sigma_r = e_r + gains.lambda_r * e_r_int

    # Adaptive gain law (same family as the ASMC's: dead zone mu, floor kmin)
    ka_dot_u = torch.where(
        state.ka_u > gains.kmin_u,
        gains.k_u * torch.sign(torch.abs(sigma_u) - gains.mu_u),
        gains.kmin_u,
    )
    ka_dot_r = torch.where(
        state.ka_r > gains.kmin_r,
        gains.k_r * torch.sign(torch.abs(sigma_r) - gains.mu_r),
        gains.kmin_r,
    )
    ka_u = 0.5 * dt * (ka_dot_u + state.ka_dot_u_last) + state.ka_u
    ka_r = 0.5 * dt * (ka_dot_r + state.ka_dot_r_last) + state.ka_r

    # Reaching law + equivalent control; feedforward dot_u/dot_r from setpoint
    ua_u = -ka_u * torch.sqrt(torch.abs(sigma_u)) * torch.sign(sigma_u) - gains.k2_u * sigma_u
    ua_r = -ka_r * torch.sqrt(torch.abs(sigma_r)) * torch.sign(sigma_r) - gains.k2_r * sigma_r

    tx = (setpoint.dot_u + gains.lambda_u * sig_e_u - f_u - ua_u) / g_u
    tz = (setpoint.dot_r + gains.lambda_r * sig_e_r - f_r - ua_r) / g_r

    tport = torch.clamp(tx / 2.0 + tz / vparams.B, gains.t_min, gains.t_max)
    tstbd = torch.clamp(
        tx / (2.0 * vparams.c) - tz / (vparams.B * vparams.c),
        gains.t_min,
        gains.t_max,
    )

    new_state = AitsmcState(
        e_u_int=e_u_int, e_r_int=e_r_int,
        e_u_last=e_u, e_r_last=e_r,
        ka_u=ka_u, ka_r=ka_r,
        ka_dot_u_last=ka_dot_u, ka_dot_r_last=ka_dot_r,
    )
    debug = {
        "e_u": e_u, "e_r": e_r, "Ka_u": ka_u, "Ka_r": ka_r,
        "sigma_u": sigma_u, "sigma_r": sigma_r,
        "tport": tport, "tstbd": tstbd,
    }
    return new_state, tport, tstbd, debug


@dataclasses.dataclass(frozen=True)
class AitsmcLoopState:
    ctrl: AitsmcState
    dyn: DynamicsState

    def replace(self, **changes) -> "AitsmcLoopState":
        return dataclasses.replace(self, **changes)


def aitsmc_compute(
    gains: AitsmcGains,
    vparams: VehicleParams,
    loop: AitsmcLoopState,
    setpoint: AitsmcSetpoint,
    perturb=None,
    n_substeps: int = 5,
    dt: float = 0.01,
    keep_history: bool = False,
):
    """N substeps of {AITSMC -> dynamics (+ external perturb force)}.

    ``perturb`` is the user's body force ``(B, 3)`` = (tau_x, tau_y, tau_z),
    constant over the substeps. Returns ``(loop, last, history)`` as
    :func:`usv_tpu_torch.control.asmc.asmc_compute` does: the last substep's
    debug dict, and every substep's stacked to ``(B, n_substeps)`` only with
    ``keep_history``.
    """
    if perturb is None:
        px = py = pz = 0.0
    else:
        px, py, pz = perturb[..., 0], perturb[..., 1], perturb[..., 2]

    ctrl, dyn = loop.ctrl, loop.dyn
    records = []
    last = None
    with span("usv.env.substeps"):
        for _ in range(n_substeps):
            ctrl, tport, tstbd, last = aitsmc_control(gains, vparams, ctrl, setpoint, dyn.vel, dt)
            dyn = dynamics_step(vparams, dyn, tport, tstbd, dt, px, py, pz)
            if keep_history:
                records.append(last)
    new = AitsmcLoopState(ctrl=ctrl, dyn=dyn)
    return new, last, (stack_history(records) if keep_history else None)

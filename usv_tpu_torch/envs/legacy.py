"""Legacy OCEANS-2020 envs: ``usv-asmc-v0``, ``usv-pid-v0``,
``usv-asmc-ye-int-v0`` — port of ``usv_tpu/envs/legacy.py``.

Reference ``usv_asmc_env.py``, ``usv_pid_env.py`` and
``usv_asmc_ye_int_env.py``: a heading-offset action (1-D, +-pi/2), an inline
controller and the full Fossen dynamics at 100 Hz with ONE substep per env
step, a cross-track/heading reward, old-gym termination semantics. These envs
cast no ray and launch no kernel.

Legacy quirks replicated deliberately, as in the JAX module:

* single-branch "wrap once" on psi_d / e_psi / psi / psi_ak
  (usv_asmc_env.py:124,148,229-232) — differs from the atan2 wrap at +-pi.
* ``e_u_last`` is read but NEVER updated (packed back unchanged,
  usv_asmc_env.py:251) — it stays 0 forever, so the speed-error integral is
  effectively trapezoid-against-zero and the PID derivative is e_u/dt.
* no second-order reference filter: ``e_psi_dot = -r`` (usv_asmc_env.py:149).
* desired speed scheduling u_d = (v_d - 0.3) * sigmoid(-10(|e_psi|2/pi - .5)) + 0.3
  (usv_asmc_env.py:153-156).
* the adaptive-gain law's else-branch is the constant ``kmin``.
* thruster saturation asymmetric [-30, 36.5] for ASMC/ye-int AND the PID env
  (usv_asmc_env.py:182-185, usv_pid_env.py:160-163).
* termination: ASMC env on |ye|>10 or |x|>30; PID and ye-int on |ye|>10 or
  x < min_x; reward forced to -1 on termination; ``truncated`` always false.
* ye-int env: integral of ye with reset-on-sign-change (``sign(0) = 0`` on
  the first step, so the first step resets too) and NON-halved trapezoid
  (ye_int += dt*(ye + ye_last); usv_asmc_ye_int_env.py:230-233), observed
  state uses ye_ss = ye + 0.001 * ye_int; its reward also differs from the
  asmc/pid form — plain exp(-k_ye*|ye|) with no sigma branch, and the action
  term added in both heading branches (:350-360).

The vehicle constants (``g_u = 1/(m - X_u_dot)``, ``c_action``) are Python
floats folded before they meet a float32 tensor, as in the JAX module. As in
the other ported envs the per-env ``key`` leaf is gone: a reset is a pure
transform of one ``(B, 7)`` uniform block.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from usv_tpu_torch.core.angles import wrap_angle_once
from usv_tpu_torch.envs.types import TimeStep, reset_from_generator
from usv_tpu_torch.physics.dynamics import (
    DynamicsState,
    dynamics_step,
    hydrodynamic_coefficients,
)
from usv_tpu_torch.physics.params import VehicleParams

_VP = VehicleParams()


@dataclasses.dataclass(frozen=True)
class LegacyConfigBase:
    integral_step: float = 0.01
    min_speed: float = 0.3
    # ASMC gains (usv_asmc_env.py:40-49)
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
    # reward shaping (usv_asmc_env.py:51-53, 77-78)
    k_ak: float = 5.72
    k_ye: float = 0.5
    sigma_ye: float = 1.0
    w_action: float = 0.2
    max_action: float = math.pi / 2
    max_ye: float = 10.0
    min_x: float = -10.0
    max_x: float = 30.0

    @property
    def c_action(self):
        return 1.0 / ((self.max_action / 2 - (-self.max_action) / 2) / self.integral_step) ** 2

    @property
    def obs_dim(self) -> int:
        return 6

    @property
    def action_dim(self) -> int:
        return 1

    @property
    def action_low(self):
        return (-math.pi / 2,)

    @property
    def action_high(self):
        return (math.pi / 2,)


@dataclasses.dataclass(frozen=True)
class LegacyAsmcConfig(LegacyConfigBase):
    pass


@dataclasses.dataclass(frozen=True)
class LegacyPidConfig(LegacyConfigBase):
    # PID gains (usv_pid_env.py:40-44)
    kp_u: float = 1.1
    ki_u: float = 0.2
    kd_u: float = 0.1
    kp_psi: float = 0.8
    kd_psi: float = 3.0


@dataclasses.dataclass(frozen=True)
class LegacyYeIntConfig(LegacyConfigBase):
    k_i: float = 0.001  # usv_asmc_ye_int_env.py:51


@dataclasses.dataclass(frozen=True)
class LegacyState:
    dyn: DynamicsState
    # target = [x_0, y_0, desired_speed, ak, x_d, y_d] (usv_asmc_env.py:296)
    target: torch.Tensor           # (B, 6)
    e_u_int: torch.Tensor          # (B,)
    ka_u: torch.Tensor             # (B,)
    ka_psi: torch.Tensor           # (B,)
    ka_dot_u_last: torch.Tensor    # (B,)
    ka_dot_psi_last: torch.Tensor  # (B,)
    action_last: torch.Tensor      # (B,)
    # ye-int extension (zeros elsewhere)
    ye_int: torch.Tensor           # (B,)
    ye_last: torch.Tensor          # (B,)
    state_vec: torch.Tensor        # (B, 6)

    def replace(self, **changes) -> "LegacyState":
        return dataclasses.replace(self, **changes)


def n_uniform(cfg: LegacyConfigBase) -> int:
    """Width of the uniform block one reset consumes."""
    return 7


def _observe(vel, ye, psi_ak, action_last):
    """state = [u, v_ak, r, ye, psi_ak, action_last] (usv_asmc_env.py:247)."""
    v_ak = torch.sin(psi_ak) * vel[:, 0] + torch.cos(psi_ak) * vel[:, 1]
    return torch.stack([vel[:, 0], v_ak, vel[:, 2], ye, psi_ak, action_last], dim=-1)


def _scaled(u, low, high):
    """U[low, high) from U[0, 1): the range is taken in float32, as the JAX
    draw takes it."""
    return u * float(np.float32(high) - np.float32(low)) + low


def _legacy_reset(cfg, u, pos_range, speed_range) -> LegacyState:
    """Reset as a pure transform of a ``(B, 7)`` block of U[0, 1) draws, in
    the JAX reset's order: x, y, psi, x_0, y_0, x_d, v_d."""
    B = u.shape[0]
    if u.shape != (B, 7):
        raise ValueError(f"uniform block {tuple(u.shape)}, expected {(B, 7)}")
    x = _scaled(u[:, 0], -pos_range, pos_range)
    y = _scaled(u[:, 1], -pos_range, pos_range)
    psi = _scaled(u[:, 2], -math.pi, math.pi)
    x_0 = _scaled(u[:, 3], -2.5, 2.5)
    y_0 = _scaled(u[:, 4], -2.5, 2.5)
    x_d = _scaled(u[:, 5], 15.0, 30.0)
    y_d = y_0
    v_d = _scaled(u[:, 6], speed_range[0], speed_range[1])
    ak = torch.atan2(y_d - y_0, x_d - x_0)

    psi_ak = wrap_angle_once(psi - ak)
    ye = -(x - x_0) * torch.sin(ak) + (y - y_0) * torch.cos(ak)
    z = torch.zeros_like(x)
    z3 = torch.zeros((B, 3), dtype=torch.float32, device=u.device)
    return LegacyState(
        dyn=DynamicsState(pose=torch.stack([x, y, psi], dim=-1), vel=z3, accel_last=z3,
                          eta_dot_last=z3),
        target=torch.stack([x_0, y_0, v_d, ak, x_d, y_d], dim=-1),
        e_u_int=z, ka_u=z, ka_psi=z,
        ka_dot_u_last=z, ka_dot_psi_last=z,
        action_last=z, ye_int=z, ye_last=z,
        state_vec=_observe(z3, ye, psi_ak, z),
    )


def _control_common(cfg, state: LegacyState, action):
    """Shared preamble: psi_d, model terms, errors. Returns a dict."""
    vel = state.dyn.vel
    pose = state.dyn.pose
    u, v, r = vel[:, 0], vel[:, 1], vel[:, 2]
    ak = state.target[:, 3]
    v_d = state.target[:, 2]

    action_dot = (action - state.action_last) / cfg.integral_step
    psi_d = wrap_angle_once(action + ak)

    Xu, Xuu, _, _, _, Nr = hydrodynamic_coefficients(u, v)
    g_u = 1.0 / (_VP.m - _VP.X_u_dot)
    g_psi = 1.0 / (_VP.Iz - _VP.N_r_dot)
    f_u = ((_VP.m - _VP.Y_v_dot) * v * r + (Xuu * torch.abs(u) + Xu * u)) * g_u
    f_psi = ((-_VP.X_u_dot + _VP.Y_v_dot) * u * v + Nr * r) * g_psi

    e_psi = wrap_angle_once(psi_d - pose[:, 2])
    e_psi_dot = -r
    u_psi = 1.0 / (1.0 + torch.exp(10.0 * (torch.abs(e_psi) * (2.0 / math.pi) - 0.5)))
    u_d = (v_d - cfg.min_speed) * u_psi + cfg.min_speed
    e_u = u_d - u
    # e_u_last is frozen at 0 in the reference (see module docstring)
    e_u_int = 0.5 * cfg.integral_step * e_u + state.e_u_int
    return dict(
        action_dot=action_dot, g_u=g_u, g_psi=g_psi, f_u=f_u, f_psi=f_psi,
        e_psi=e_psi, e_psi_dot=e_psi_dot, e_u=e_u, e_u_int=e_u_int,
    )


def _asmc_law(cfg, state: LegacyState, c):
    sigma_u = c["e_u"] + cfg.lambda_u * c["e_u_int"]
    sigma_psi = c["e_psi_dot"] + cfg.lambda_psi * c["e_psi"]
    ka_dot_u = torch.where(
        state.ka_u > cfg.kmin_u,
        cfg.k_u * torch.sign(torch.abs(sigma_u) - cfg.mu_u), cfg.kmin_u,
    )
    ka_dot_psi = torch.where(
        state.ka_psi > cfg.kmin_psi,
        cfg.k_psi * torch.sign(torch.abs(sigma_psi) - cfg.mu_psi), cfg.kmin_psi,
    )
    ka_u = 0.5 * cfg.integral_step * (ka_dot_u + state.ka_dot_u_last) + state.ka_u
    ka_psi = (
        0.5 * cfg.integral_step * (ka_dot_psi + state.ka_dot_psi_last) + state.ka_psi
    )
    ua_u = -ka_u * torch.sqrt(torch.abs(sigma_u)) * torch.sign(sigma_u) - cfg.k2_u * sigma_u
    ua_psi = (
        -ka_psi * torch.sqrt(torch.abs(sigma_psi)) * torch.sign(sigma_psi)
        - cfg.k2_psi * sigma_psi
    )
    tx = (cfg.lambda_u * c["e_u"] - c["f_u"] - ua_u) / c["g_u"]
    tz = (cfg.lambda_psi * c["e_psi"] - c["f_psi"] - ua_psi) / c["g_psi"]
    ctrl_updates = dict(
        ka_u=ka_u, ka_psi=ka_psi,
        ka_dot_u_last=ka_dot_u, ka_dot_psi_last=ka_dot_psi,
    )
    return tx, tz, ctrl_updates


def _pid_law(cfg: LegacyPidConfig, state: LegacyState, c):
    e_u_dot = c["e_u"] / cfg.integral_step  # e_u_last frozen at 0
    ua_u = cfg.kp_u * c["e_u"] + cfg.ki_u * c["e_u_int"] + cfg.kd_u * e_u_dot
    ua_psi = cfg.kp_psi * c["e_psi"] + cfg.kd_psi * c["e_psi_dot"]
    tx = (-c["f_u"] + ua_u) / c["g_u"]
    tz = (-c["f_psi"] + ua_psi) / c["g_psi"]
    return tx, tz, {}


def _mix_saturate(tx, tz):
    """Asymmetric thruster saturation [-30, 36.5] (usv_asmc_env.py:179-185)."""
    tport = torch.clamp(tx / 2.0 + tz / _VP.B, -30.0, 36.5)
    tstbd = torch.clamp(tx / (2.0 * _VP.c) - tz / (_VP.B * _VP.c), -30.0, 36.5)
    return tport, tstbd


def _reward(cfg, ye_abs, psi_ak, action_dot, ye_int_mode=False):
    """usv_asmc_env.py:364-374 / usv_pid_env.py:329-338.

    The ye-int env's reward differs in TWO ways (usv_asmc_ye_int_env.py
    :350-360): ``reward_ye`` is the plain exponential ``exp(-k_ye*|ye|)``
    with no near-path sigma branch, and ``reward_action`` is added in BOTH
    branches (the asmc/pid form drops it when |psi_ak| >= pi/2).
    """
    abs_psi = torch.abs(psi_ak)
    reward_action = cfg.w_action * torch.tanh(-cfg.c_action * action_dot ** 2)
    reward_ak = -torch.exp(cfg.k_ak * (abs_psi - math.pi))
    if ye_int_mode:
        reward_ye = torch.exp(-cfg.k_ye * ye_abs)
        return reward_action + torch.where(abs_psi < math.pi / 2, reward_ye, reward_ak)
    reward_ye = torch.where(
        ye_abs > cfg.sigma_ye,
        torch.exp(-cfg.k_ye * ye_abs),
        torch.exp(-cfg.k_ye * ye_abs ** 2 / cfg.sigma_ye),
    )
    return torch.where(abs_psi < math.pi / 2, reward_action + reward_ye, reward_ak)


def _legacy_step(cfg, state: LegacyState, action, law, done_fn, ye_int_mode=False):
    action = action.reshape(action.shape[0])  # (B, 1) or (B,)
    c = _control_common(cfg, state, action)
    tx, tz, ctrl_updates = law(cfg, state, c)
    tport, tstbd = _mix_saturate(tx, tz)
    dyn = dynamics_step(_VP, state.dyn, tport, tstbd, cfg.integral_step)

    psi = wrap_angle_once(dyn.pose[:, 2])
    # a new pose tensor: the model's (and the caller's) is never written into
    dyn = dyn.replace(pose=torch.cat([dyn.pose[:, :2], psi[:, None]], dim=-1))
    ak = state.target[:, 3]
    psi_ak = wrap_angle_once(psi - ak)
    x_0, y_0 = state.target[:, 0], state.target[:, 1]
    ye = -(dyn.pose[:, 0] - x_0) * torch.sin(ak) + (dyn.pose[:, 1] - y_0) * torch.cos(ak)
    ye_abs = torch.abs(ye)

    ye_int = state.ye_int
    ye_last = state.ye_last
    if ye_int_mode:
        # reset on sign change; non-halved trapezoid (ye_int_env :230-233)
        ye_int = torch.where(torch.sign(ye) != torch.sign(ye_last), 0.0, ye_int)
        ye_int = cfg.integral_step * (ye + ye_last) + ye_int
        ye_last = ye
        ye_obs = ye + cfg.k_i * ye_int
    else:
        ye_obs = ye

    reward = _reward(cfg, ye_abs, psi_ak, c["action_dot"], ye_int_mode)
    done = done_fn(cfg, ye_abs, dyn.pose)
    reward = torch.where(done, -1.0, reward)

    state_vec = _observe(dyn.vel, ye_obs, psi_ak, action)
    new_state = state.replace(
        dyn=dyn,
        e_u_int=c["e_u_int"],
        action_last=action,
        ye_int=ye_int,
        ye_last=ye_last,
        state_vec=state_vec,
        **ctrl_updates,
    )
    info = {
        "position": dyn.pose, "velocity": dyn.vel,
        "ye": ye, "psi_ak": psi_ak,
        "tport": tport, "tstbd": tstbd,
    }
    return new_state, TimeStep(
        obs=state_vec, reward=reward,
        terminated=done, truncated=torch.zeros_like(done), info=info,
    )


def _state_vec(cfg, state: LegacyState):
    return state.state_vec


# ---- usv-asmc-v0 ------------------------------------------------------------

def reset_from_uniform_asmc(cfg: LegacyAsmcConfig, u) -> LegacyState:
    return _legacy_reset(cfg, u, pos_range=2.5, speed_range=(1.4, 2.4))


def _done_asmc(cfg, ye_abs, pose):
    # |ye| > 10 or |x| > 30 (usv_asmc_env.py:241)
    return (ye_abs > cfg.max_ye) | (torch.abs(pose[:, 0]) > cfg.max_x)


def step_asmc(cfg: LegacyAsmcConfig, state: LegacyState, action):
    return _legacy_step(cfg, state, action, _asmc_law, _done_asmc)


reset_asmc = reset_from_generator(reset_from_uniform_asmc, n_uniform)
reset_obs_asmc = _state_vec


# ---- usv-pid-v0 -------------------------------------------------------------

def reset_from_uniform_pid(cfg: LegacyPidConfig, u) -> LegacyState:
    # desired_speed ~ uniform(0.4, 1.4) — usv_pid_env.py:257 (slower than the
    # ASMC env's 1.4-2.4)
    return _legacy_reset(cfg, u, pos_range=2.5, speed_range=(0.4, 1.4))


def _done_min_x(cfg, ye_abs, pose):
    # |ye| > 10 or x < min_x (usv_pid_env.py:219)
    return (ye_abs > cfg.max_ye) | (pose[:, 0] < cfg.min_x)


def step_pid(cfg: LegacyPidConfig, state: LegacyState, action):
    return _legacy_step(cfg, state, action, _pid_law, _done_min_x)


reset_pid = reset_from_generator(reset_from_uniform_pid, n_uniform)
reset_obs_pid = _state_vec


# ---- usv-asmc-ye-int-v0 -----------------------------------------------------

def reset_from_uniform_ye_int(cfg: LegacyYeIntConfig, u) -> LegacyState:
    # wider start box, slower speeds (ye_int_env :258-279)
    return _legacy_reset(cfg, u, pos_range=5.0, speed_range=(0.4, 1.4))


def step_ye_int(cfg: LegacyYeIntConfig, state: LegacyState, action):
    return _legacy_step(cfg, state, action, _asmc_law, _done_min_x, ye_int_mode=True)


reset_ye_int = reset_from_generator(reset_from_uniform_ye_int, n_uniform)
reset_obs_ye_int = _state_vec

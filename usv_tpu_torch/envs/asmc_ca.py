"""``usv-asmc-ca-v0`` — the collision-avoidance env with the full-dynamics ASMC
— port of ``usv_tpu/envs/asmc_ca.py``.

Per 10 Hz env step: 10 substeps of {ASMC @ 100 Hz -> Fossen dynamics}, an
analytic collision test, a 16-ray lidar through the ray-cast kernel, the
body-frame tracking error and the velocity-biased tracking reward (reference
``gym_usv/envs/usv_asmc_ca_env.py``; line cites below are the reference's).

Semantics kept from the JAX module:

* action denormalization [-1,1] -> ([-1,1], [-pi,pi]) (:160-163); the heading
  channel is an ABSOLUTE world heading handed to the ASMC setpoint (:196-198).
* the optional moving-average action filter window (:165-171; off by default).
* an action history of length 1 whose mean (the previous action) enters the
  state BEFORE the current action is appended (:283-293).
* the termination ladder (:295-310): arrived (<1.5 m) -> terminated;
  collision -> truncated; tracking error > 40 m -> terminated with reward
  -100; |pose| > 100 -> terminated AND truncated.
* reset draws start, target and obstacles, prunes obstacles near the start
  AND the target (:376-398), then takes one real step with action [-1, 0] to
  produce the first observation (:402): the returned state embeds that step.
* ``perturb_range`` is accepted and the perturbation counter advances, but
  the force is never applied in the ASMC branch (:199), so it is inert here.
* a fixed obstacle capacity (16) with a validity mask; num_obs ~
  uniform(2, 10) as in :349.

As in ``envs/simple.py`` the per-env ``key`` leaf is gone: a reset is a pure
transform of one ``(B, 6 + 3K)`` uniform block with the JAX reset's layout.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from usv_tpu_torch.control.asmc import (
    AsmcGains,
    AsmcLoopState,
    AsmcState,
    asmc_compute,
    init_asmc,
)
from usv_tpu_torch.core.angles import wrap_angle
from usv_tpu_torch.core.geometry import denormalize_val
from usv_tpu_torch.envs.simple import _const, box_muller
from usv_tpu_torch.envs.types import TimeStep, reset_from_generator
from usv_tpu_torch.ops.dispatch import sensor_raycast
from usv_tpu_torch.physics.dynamics import DynamicsState
from usv_tpu_torch.physics.params import VehicleParams


@dataclasses.dataclass(frozen=True)
class CaEnvConfig:
    sensor_num: int = 16
    sensor_span: float = (2.0 / 3.0) * 2.0 * math.pi
    sensor_max_range: float = 100.0
    obstacle_cap: int = 16
    boat_radius: float = 0.1
    safety_radius: float = 0.3
    # Map limits (reference :59-63)
    min_x: float = -10.0
    max_x: float = 30.0
    min_y: float = -10.0
    max_y: float = 10.0
    # Normalization (reference :80-86)
    max_u: float = 2.5 / 2.0
    max_r: float = 3.5
    max_episode_steps: int = 5000  # gym_usv/__init__.py:19-22
    n_substeps: int = 10
    substep_dt: float = 0.01
    place_obstacles: bool = True
    strict_compat_raycast: bool = True
    raycast_backend: str = "auto"  # see SimpleEnvConfig.raycast_backend
    # moving-average action filter (reference :94-97,165-171)
    filter_action: bool = False
    filter_window_size: int = 5
    # perturbation window: tracked but inert in the ASMC branch (see the
    # module docstring); kept for API parity (reference ctor :24)
    perturb_range: tuple = (0, 0)
    # Expose the full per-substep controller and model history in info as
    # (B, n_substeps, ...) tensors: the reference's controller_history and
    # model_history entries (:312-323)
    debug_history: bool = False

    @property
    def obs_dim(self) -> int:
        return 7 + self.sensor_num

    @property
    def action_dim(self) -> int:
        return 2

    @property
    def action_low(self):
        return (-1.0, -1.0)

    @property
    def action_high(self):
        return (1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class CaEnvState:
    ctrl: AsmcState
    dyn: DynamicsState
    target_point: torch.Tensor     # (B, 2)
    obs_xy: torch.Tensor           # (B, K, 2)
    obs_r: torch.Tensor            # (B, K)
    obs_mask: torch.Tensor         # (B, K) bool
    action_history: torch.Tensor   # (B, 2) previous action (history length 1)
    filter_window: torch.Tensor    # (B, W, 2)
    filter_window_i: torch.Tensor  # (B,) int32
    sensor_dist: torch.Tensor      # (B, R)
    state_vec: torch.Tensor        # (B, 7 + R) last observation
    perturb_step: torch.Tensor     # (B,) int32
    step_count: torch.Tensor       # (B,) int32

    def replace(self, **changes) -> "CaEnvState":
        return dataclasses.replace(self, **changes)


def n_uniform(cfg: CaEnvConfig) -> int:
    """Width of the uniform block one reset consumes."""
    return 6 + 3 * cfg.obstacle_cap


def build_core(cfg: CaEnvConfig, u: torch.Tensor) -> CaEnvState:
    """Start, target and obstacles (reference reset :327-398, before its
    trailing step) as a pure transform of a ``(B, 6 + 3K)`` block of U[0, 1)
    draws.

    Layout (the JAX reset's): [0] x, [1] y, [2] theta, [3:5] target, [5]
    num_obs, [6:6+K] obs_r, [6+K:6+3K] Box-Muller uniforms for (K, 2) normals.
    """
    B, K = u.shape[0], cfg.obstacle_cap
    if u.shape != (B, n_uniform(cfg)):
        raise ValueError(f"uniform block {tuple(u.shape)}, expected {(B, n_uniform(cfg))}")
    device = u.device
    x = cfg.min_x + u[:, 0] * (cfg.max_x - cfg.min_x)
    y = cfg.min_y + u[:, 1] * 5.0
    theta = (u[:, 2] - 0.5) * (math.pi / 2)
    pose = torch.stack([x, y, theta], dim=-1)

    target = (
        _const((cfg.min_x, cfg.max_y - 5.0), device)
        + u[:, 3:5] * _const((cfg.max_x - 10.0 - cfg.min_x, 4.0), device)
    )

    if cfg.place_obstacles:
        num_obs = (2.0 + 8.0 * u[:, 5]).to(torch.int32)  # floored: 2..9
    else:
        num_obs = torch.zeros(B, dtype=torch.int32, device=device)
    center = 0.5 * (pose[:, :2] + target)
    obs_r = 1.0 + u[:, 6:6 + K]
    n0, n1 = box_muller(u[:, 6 + K:6 + 2 * K], u[:, 6 + 2 * K:6 + 3 * K])
    obs_xy = center[:, None, :] + torch.stack([n0, n1], dim=-1) * 10.0
    mask = torch.arange(K, device=device) < num_obs[:, None]

    # Prune obstacles near the start and near the target (:376-398)
    margin = cfg.boat_radius + cfg.safety_radius + 0.35
    d_start = torch.hypot(obs_xy[..., 0] - pose[:, 0:1], obs_xy[..., 1] - pose[:, 1:2]) - obs_r - margin
    d_tgt = torch.hypot(obs_xy[..., 0] - target[:, 0:1], obs_xy[..., 1] - target[:, 1:2]) - obs_r - margin
    mask = mask & (d_start >= 0) & (d_tgt >= 0)

    z3 = torch.zeros((B, 3), dtype=torch.float32, device=device)
    zi = torch.zeros(B, dtype=torch.int32, device=device)
    return CaEnvState(
        ctrl=init_asmc((B,), device=device),
        dyn=DynamicsState(pose=pose, vel=z3, accel_last=z3, eta_dot_last=z3),
        target_point=target,
        obs_xy=obs_xy,
        obs_r=obs_r,
        obs_mask=mask,
        action_history=torch.zeros((B, 2), dtype=torch.float32, device=device),
        filter_window=torch.zeros((B, cfg.filter_window_size, 2), dtype=torch.float32,
                                  device=device),
        filter_window_i=zi,
        sensor_dist=torch.full((B, cfg.sensor_num), cfg.sensor_max_range,
                               dtype=torch.float32, device=device),
        state_vec=torch.zeros((B, cfg.obs_dim), dtype=torch.float32, device=device),
        perturb_step=zi,
        step_count=zi,
    )


def bootstrap(cfg: CaEnvConfig, state: CaEnvState) -> CaEnvState:
    """The reference reset's trailing real step with action [-1, 0] (:402);
    apart from :func:`build_core` so that a scene can be injected before it.
    The step consumes no episode budget and no perturbation window."""
    B = state.step_count.shape[0]
    state, _ = step(cfg, state, _const((-1.0, 0.0), state.step_count.device).expand(B, 2))
    zi = torch.zeros_like(state.step_count)
    return state.replace(step_count=zi, perturb_step=zi)


def reset_from_uniform(cfg: CaEnvConfig, u: torch.Tensor) -> CaEnvState:
    """Sample a scene from the block, then take one step with action [-1, 0]."""
    return bootstrap(cfg, build_core(cfg, u))


reset = reset_from_generator(reset_from_uniform, n_uniform)


def reset_obs(cfg: CaEnvConfig, state: CaEnvState):
    return state.state_vec


def step(
    cfg: CaEnvConfig,
    state: CaEnvState,
    action_in,
    gains: AsmcGains = AsmcGains(),
    vparams: VehicleParams = VehicleParams(),
):
    """One 10 Hz step of every env — reference ``step`` :146-325, same op
    order. ``action_in`` is (B, 2) in [-1, 1]."""
    action = torch.stack([
        denormalize_val(action_in[:, 0], -1.0, 1.0),
        denormalize_val(action_in[:, 1], -math.pi, math.pi),
    ], dim=-1)

    filter_window = state.filter_window
    filter_window_i = state.filter_window_i
    if cfg.filter_action:
        # each env writes its own slot of the window
        slot = filter_window_i.to(torch.int64)[:, None, None].expand(-1, 1, 2)
        filter_window = filter_window.scatter(1, slot, action[:, None, :])
        filter_window_i = (filter_window_i + 1) % cfg.filter_window_size
        action = filter_window.mean(dim=1)

    perturb_step = state.perturb_step + 1
    # the perturbation window is tracked for parity; the force is inert

    loop = AsmcLoopState(
        ctrl=state.ctrl, dyn=state.dyn, perturb_step=torch.zeros_like(state.perturb_step)
    )
    loop, last, history = asmc_compute(
        gains, vparams, loop, action,
        n_substeps=cfg.n_substeps, dt=cfg.substep_dt,
        absolute_heading=True, keep_history=cfg.debug_history,
    )
    dyn = loop.dyn
    pose, vel = dyn.pose, dyn.vel
    px, py, psi = pose[:, 0], pose[:, 1], pose[:, 2]

    # Analytic collision vs obstacle boundaries (:229-246). A row with no
    # valid obstacle has the minimum +inf: no collision.
    boundary = (
        torch.hypot(state.obs_xy[..., 0] - px[:, None], state.obs_xy[..., 1] - py[:, None])
        - state.obs_r - cfg.boat_radius
    )
    collision = torch.where(state.obs_mask, boundary, math.inf).amin(-1) < 0.0

    # Lidar (:249-259); the ordering key is the boundary distance
    sensor_dist = sensor_raycast(
        pose, state.obs_xy, state.obs_r, state.obs_mask, boundary,
        cfg.sensor_num, cfg.sensor_max_range, cfg.sensor_span,
        strict_compat=cfg.strict_compat_raycast,
        backend=cfg.raycast_backend,
    )
    sensors_norm = sensor_dist / cfg.sensor_max_range

    # Guidance errors (:261-270)
    tx, ty = state.target_point[:, 0], state.target_point[:, 1]
    distance_to_target = torch.hypot(px - tx, py - ty)
    angle_to_target = wrap_angle(torch.atan2(ty - py, tx - px) - psi)
    c, s = torch.cos(psi), torch.sin(psi)
    dx, dy = tx - px, ty - py
    tracking_error = torch.stack([
        c * dx + s * dy,
        -s * dx + c * dy,
        wrap_angle(angle_to_target),
    ], dim=-1)
    div_fac = cfg.max_x ** 2 + cfg.max_y ** 2
    normalized_te = tracking_error / _const((div_fac, div_fac, math.pi), pose.device)

    arrived = distance_to_target < 1.5

    # Reward (:275-281, 485-498)
    te_norm = torch.hypot(tracking_error[:, 0], tracking_error[:, 1])
    r_tracking_error = -te_norm / 75.0 - torch.abs(angle_to_target / math.pi)
    r_velocity = torch.hypot(vel[:, 0], vel[:, 1])
    reward = r_tracking_error + r_velocity * 0.5

    # State vector (:283-288): the mean of the PREVIOUS action history
    state_vec = torch.cat([
        torch.stack([vel[:, 0] / cfg.max_u, vel[:, 2] / cfg.max_r], dim=-1),
        normalized_te,
        state.action_history / max(1.0, math.pi),
        sensors_norm,
    ], dim=-1)

    # Termination ladder (:295-310)
    far = te_norm > 40.0
    reward = torch.where(far, reward - 100.0, reward)
    oob = pose.abs().amax(-1) > 100.0
    terminated = arrived | far | oob
    step_count = state.step_count + 1
    truncated = collision | oob | (step_count >= cfg.max_episode_steps)

    info = {
        "action": action,
        "position": pose,
        "velocity": vel,
        "action_in": action_in,
        "target": state.target_point,
        "distance_to_target": distance_to_target,
        "arrived": arrived,
        "collision": collision,
        "r_tracking_error": r_tracking_error,
        "left_thruster": last["tport"],
        "right_thruster": last["tstbd"],
    }
    if cfg.debug_history:
        # the C++ binding's field names (heading_error, heading_gain, Tz...)
        info["controller_history"] = {
            "left_thruster": history["tport"],
            "right_thruster": history["tstbd"],
            "speed_error": history["e_u"],
            "heading_error": history["e_psi"],
            "speed_gain": history["ka_u"],
            "heading_gain": history["ka_psi"],
            "speed_sigma": history["sigma_u"],
            "heading_sigma": history["sigma_psi"],
            "Tx": history["tx"],
            "Tz": history["tz"],
        }
        info["model_history"] = {"pose": history["pose"], "vel": history["vel"]}

    new_state = state.replace(
        ctrl=loop.ctrl,
        dyn=dyn,
        action_history=action,
        filter_window=filter_window,
        filter_window_i=filter_window_i,
        sensor_dist=sensor_dist,
        state_vec=state_vec,
        perturb_step=perturb_step,
        step_count=step_count,
    )
    return new_state, TimeStep(
        obs=state_vec,
        reward=reward,
        terminated=terminated,
        truncated=truncated,
        info=info,
    )

"""``usv-curved-aitsmc`` — curved/waypoint path following with the AITSMC loop
— port of ``usv_tpu/envs/curved.py``.

Per env step: the policy action becomes (u, r) setpoints through an EMA
filter, 5 substeps of {AITSMC -> Fossen dynamics}, a 32-ray sensor sweep over
the obstacles jittered along the path through the ray-cast kernel, a lookahead
target on the env's own PCHIP path, the vertical cross-track error
``ye = path(x) - y``, and the simple-env-shaped reward with the curved task's
constants (``ye_k`` 0.5, a single exponential in ye).

Semantics kept from the JAX module:

* the reset draws a random PCHIP waypoint path and obstacles along it per env
  (``utils/path_gen`` semantics); the first step is forced to zero before the
  cumulative sum, so every path starts at the origin; the clip of the angles
  to (-pi/2 + 0.1, pi/2 - 0.1) keeps x strictly increasing;
* an obstacle is valid if its radius exceeds 0.05, it lies more than 1.5 m
  from the start and its slot is below ``n_obs`` ~ randint(4, K);
* the reset takes no step and casts no ray: ``sensor_dist`` starts at
  ``sensor_max_range``;
* the lookahead target clamps at BOTH ends of the path
  (``path_gen.simplified_lookahead`` only at the start);
* the reward's setpoint delta is taken against the previous setpoint, before
  ``last_setpoint`` is replaced.

Divergence (documented, not a bug): the per-env ``key`` leaf is gone. The JAX
reset splits its key nine ways and draws normals; here a reset is a pure
transform of its draws (:func:`build_from_draws`), and
:func:`reset_from_uniform` makes those draws from one uniform block, normals
by Box-Muller. The distributions are JAX's; the bit streams are not.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from usv_tpu_torch.control.aitsmc import (
    AitsmcGains,
    AitsmcLoopState,
    AitsmcSetpoint,
    AitsmcState,
    aitsmc_compute,
    init_aitsmc,
)
from usv_tpu_torch.core.angles import wrap_angle
from usv_tpu_torch.envs.simple import box_muller
from usv_tpu_torch.envs.types import TimeStep, reset_from_generator
from usv_tpu_torch.ops.dispatch import sensor_raycast
from usv_tpu_torch.physics.dynamics import DynamicsState
from usv_tpu_torch.physics.params import VehicleParams
from usv_tpu_torch.utils.path_gen import PchipPath, pchip_eval, pchip_fit


@dataclasses.dataclass(frozen=True)
class CurvedEnvConfig:
    num_waypoints: int = 8
    # waypoint polar sampling (reference path_gen.py:6-8)
    angle_std: float = 0.5
    length_mean: float = 3.0
    length_std: float = 0.1
    lookahead: float = 1.0
    # obstacles along the path (reference path_gen.py:17-38)
    obstacle_cap: int = 16
    obs_pos_std: float = 4.0
    obs_rad_mean: float = 0.8
    obs_rad_std: float = 0.1
    sensor_count: int = 32
    sensor_max_range: float = 100.0
    sensor_span: float = (2.0 / 3.0) * 2.0 * math.pi
    strict_compat_raycast: bool = True
    raycast_backend: str = "auto"  # see SimpleEnvConfig.raycast_backend
    # AITSMC substep loop
    n_substeps: int = 5
    substep_dt: float = 0.01
    # setpoint scaling: action in [-1,1]^2 -> u in [0, max_u], r in +-max_r
    max_u: float = 1.0
    max_r: float = 1.5
    reference_velocity: float = 0.5
    max_episode_steps: int = 1000
    max_ye: float = 10.0
    ye_k: float = 0.5
    collision_penalty: float = -20.0

    @property
    def obs_dim(self) -> int:
        # vel(3) + [angle, dist, ye, ref_vel](4) + last setpoint(2) + sensors
        return 9 + self.sensor_count

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
class CurvedEnvState:
    ctrl: AitsmcState
    dyn: DynamicsState
    path: PchipPath               # per-env PCHIP path y(x), knots (B, W)
    waypoints: torch.Tensor       # (B, W, 2)
    obs_xy: torch.Tensor          # (B, K, 2)
    obs_r: torch.Tensor           # (B, K)
    obs_mask: torch.Tensor        # (B, K) bool
    last_setpoint: torch.Tensor   # (B, 2) EMA-filtered (u, r)
    sensor_dist: torch.Tensor     # (B, R)
    step_count: torch.Tensor      # (B,) int32

    def replace(self, **changes) -> "CurvedEnvState":
        return dataclasses.replace(self, **changes)


def n_uniform(cfg: CurvedEnvConfig) -> int:
    """Width of the uniform block one reset consumes."""
    return 2 + 2 * cfg.obstacle_cap + 2 * (cfg.num_waypoints + cfg.obstacle_cap)


def build_from_draws(cfg: CurvedEnvConfig, angles, lengths, psi0, base_u, displacement,
                     off_angle, obs_r, n_obs) -> CurvedEnvState:
    """The reset as a pure transform of its draws (the JAX reset, fed the
    arrays it draws from its nine keys, gives the same state).

    ``angles``, ``lengths`` : (B, W) standard normals (waypoint headings, step lengths)
    ``psi0``                : (B,) start heading, uniform in [-pi/4, pi/4)
    ``base_u``              : (B, K) uniform in [0, 1): the obstacles' abscissae as
                              a share of the path's x extent
    ``displacement``        : (B, K) standard normals (offset from the path)
    ``off_angle``           : (B, K) offset direction, uniform in [pi, 2 pi)
    ``obs_r``               : (B, K) standard normals (radius)
    ``n_obs``               : (B,) integers in [4, K): slots in use
    """
    B, K = psi0.shape[0], cfg.obstacle_cap
    device = psi0.device

    # random polar waypoints -> cumsum (path_gen.py:6-12 semantics)
    angles = torch.clamp(cfg.angle_std * angles, -math.pi / 2 + 0.1, math.pi / 2 - 0.1)
    lengths = cfg.length_mean + cfg.length_std * lengths
    steps = lengths[..., None] * torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    steps = torch.cat([torch.zeros_like(steps[:, :1]), steps[:, 1:]], dim=1)
    waypoints = torch.cumsum(steps, dim=1)
    # strictly increasing x is required for the interpolant: cos(angle) > 0
    # by the clip above, so the cumulative x is monotone
    path = pchip_fit(waypoints[..., 0], waypoints[..., 1])

    # randomized start: at the first waypoint with heading jitter
    pose = torch.stack([waypoints[:, 0, 0], waypoints[:, 0, 1], psi0], dim=-1)

    # obstacles jittered along the path (path_gen.py:17-38 semantics)
    x_first, x_last = waypoints[:, 0, 0:1], waypoints[:, -1, 0:1]
    base_x = base_u * (x_last - x_first) + x_first
    displacement = cfg.obs_pos_std * displacement
    on_path = torch.stack([base_x, pchip_eval(path, base_x)], dim=-1)
    obs_xy = on_path + displacement[..., None] * torch.stack(
        [torch.cos(off_angle), torch.sin(off_angle)], dim=-1)
    obs_r = cfg.obs_rad_mean + cfg.obs_rad_std * obs_r
    # valid: positive radius, and not within 1.5 m of the start
    d_start = torch.hypot(obs_xy[..., 0] - pose[:, 0:1], obs_xy[..., 1] - pose[:, 1:2]) - obs_r
    obs_mask = (obs_r > 0.05) & (d_start > 1.5) & (torch.arange(K, device=device) < n_obs[:, None])

    z3 = torch.zeros((B, 3), dtype=torch.float32, device=device)
    return CurvedEnvState(
        ctrl=init_aitsmc((B,), device=device),
        dyn=DynamicsState(pose=pose, vel=z3, accel_last=z3, eta_dot_last=z3),
        path=path,
        waypoints=waypoints,
        obs_xy=obs_xy,
        obs_r=obs_r,
        obs_mask=obs_mask,
        last_setpoint=torch.zeros((B, 2), dtype=torch.float32, device=device),
        sensor_dist=torch.full((B, cfg.sensor_count), cfg.sensor_max_range,
                               dtype=torch.float32, device=device),
        step_count=torch.zeros(B, dtype=torch.int32, device=device),
    )


def reset_from_uniform(cfg: CurvedEnvConfig, u: torch.Tensor) -> CurvedEnvState:
    """A reset as a pure transform of a ``(B, n_uniform(cfg))`` float32 block
    of U[0, 1) draws, through :func:`build_from_draws`.

    Layout, with W waypoints and K obstacle slots: [0] psi0, [1] n_obs,
    [2:2+K] base_u, [2+K:2+2K] off_angle, then two runs of W+K Box-Muller
    uniforms. The first normal of each pair gives [angles (W) | displacement
    (K)], the second [lengths (W) | obs_r (K)].
    """
    B, W, K = u.shape[0], cfg.num_waypoints, cfg.obstacle_cap
    if u.shape != (B, n_uniform(cfg)):
        raise ValueError(f"uniform block {tuple(u.shape)}, expected {(B, n_uniform(cfg))}")
    psi0 = u[:, 0] * (math.pi / 2) - math.pi / 4
    # randint(4, K): floor of a uniform over K - 4 values (u < 1 so <= K - 1)
    n_obs = 4 + torch.floor(u[:, 1] * (K - 4)).to(torch.int32)
    base_u = u[:, 2:2 + K]
    off_angle = u[:, 2 + K:2 + 2 * K] * math.pi + math.pi
    at = 2 + 2 * K
    n0, n1 = box_muller(u[:, at:at + W + K], u[:, at + W + K:at + 2 * (W + K)])
    return build_from_draws(cfg, n0[:, :W], n1[:, :W], psi0, base_u, n0[:, W:], off_angle,
                            n1[:, W:], n_obs)


reset = reset_from_generator(reset_from_uniform, n_uniform)


def _lookahead_target(cfg: CurvedEnvConfig, state: CurvedEnvState):
    """simplified_lookahead (path_gen.py:50-54): x + lookahead, clamped to
    the path's first and last waypoint. Returns (B, 2)."""
    x = torch.maximum(state.dyn.pose[:, 0] + cfg.lookahead, state.waypoints[:, 0, 0])
    x = torch.minimum(x, state.waypoints[:, -1, 0])
    return torch.stack([x, pchip_eval(state.path, x)], dim=-1)


def _observe(cfg: CurvedEnvConfig, state: CurvedEnvState, target, angle=None, ye=None):
    """The (B, 9 + R) observation; ``angle`` and ``ye`` when the caller has
    them already (the step computes both for the reward)."""
    pose, vel = state.dyn.pose, state.dyn.vel
    delta = target - pose[:, :2]
    if angle is None:
        angle = wrap_angle(torch.atan2(delta[:, 1], delta[:, 0]) - pose[:, 2])
    dist = torch.hypot(delta[:, 0], delta[:, 1])
    if ye is None:
        ye = pchip_eval(state.path, pose[:, 0]) - pose[:, 1]
    return torch.cat([
        vel / 10.0,
        torch.stack([
            angle / math.pi, dist / 10.0, ye / 10.0,
            torch.full_like(ye, cfg.reference_velocity / 10.0),
        ], dim=-1),
        state.last_setpoint,
        state.sensor_dist / cfg.sensor_max_range,
    ], dim=-1)


def reset_obs(cfg: CurvedEnvConfig, state: CurvedEnvState):
    return _observe(cfg, state, _lookahead_target(cfg, state))


def step(
    cfg: CurvedEnvConfig,
    state: CurvedEnvState,
    action,
    gains: AitsmcGains = AitsmcGains(),
    vparams: VehicleParams = VehicleParams(),
):
    """One step of every env; ``action`` is (B, 2) in [-1, 1]."""
    # EMA setpoint filter (simple_env_aitsmc.py:58 semantics), scaled
    raw = torch.stack([
        (action[:, 0] + 1.0) * 0.5 * cfg.max_u,  # u in [0, max_u]
        action[:, 1] * cfg.max_r,
    ], dim=-1)
    setpoint_vals = 0.8 * state.last_setpoint + 0.2 * raw
    setpoint = AitsmcSetpoint(u=setpoint_vals[:, 0], r=setpoint_vals[:, 1], dot_u=0.0, dot_r=0.0)

    loop = AitsmcLoopState(ctrl=state.ctrl, dyn=state.dyn)
    loop, last_debug, _ = aitsmc_compute(
        gains, vparams, loop, setpoint,
        n_substeps=cfg.n_substeps, dt=cfg.substep_dt,
    )
    pose, vel = loop.dyn.pose, loop.dyn.vel

    # sensors over the path obstacles
    boundary = (
        torch.hypot(state.obs_xy[..., 0] - pose[:, 0:1], state.obs_xy[..., 1] - pose[:, 1:2])
        - state.obs_r
    )
    sensor_dist = sensor_raycast(
        pose, state.obs_xy, state.obs_r, state.obs_mask, boundary,
        cfg.sensor_count, cfg.sensor_max_range, cfg.sensor_span,
        strict_compat=cfg.strict_compat_raycast,
        backend=cfg.raycast_backend,
    )
    state = state.replace(ctrl=loop.ctrl, dyn=loop.dyn, sensor_dist=sensor_dist)

    target = _lookahead_target(cfg, state)
    delta = target - pose[:, :2]
    angle = wrap_angle(torch.atan2(delta[:, 1], delta[:, 0]) - pose[:, 2])
    ye = pchip_eval(state.path, pose[:, 0]) - pose[:, 1]

    # a row with no valid obstacle has the minimum +inf: no collision
    collision = torch.where(state.obs_mask, boundary, math.inf).amin(-1) < 0.05

    ye_reward = torch.exp(-torch.abs(ye / cfg.ye_k))
    angle_reward = torch.exp(-torch.abs(angle))
    speed = torch.hypot(vel[:, 0], vel[:, 1])
    velocity_track_reward = torch.exp(-torch.abs(speed - cfg.reference_velocity)) * 0.05
    # against the PREVIOUS setpoint: last_setpoint is replaced below
    delta_action_reward = -0.5 * 0.15 * torch.sum(
        torch.abs(setpoint_vals - state.last_setpoint), dim=-1)
    collision_reward = torch.where(collision, cfg.collision_penalty, 0.0)
    reward = (
        ye_reward + angle_reward + velocity_track_reward
        + delta_action_reward + collision_reward
    )

    arrived = pose[:, 0] >= state.waypoints[:, -1, 0]
    off_track = torch.abs(ye) > cfg.max_ye
    terminated = collision | arrived | off_track
    step_count = state.step_count + 1
    truncated = step_count >= cfg.max_episode_steps

    state = state.replace(last_setpoint=setpoint_vals, step_count=step_count)
    obs = _observe(cfg, state, target, angle, ye)
    info = {
        "position": pose,
        "velocity": vel,
        "ye": ye,
        "angle_to_target": angle,
        "arrived": arrived,
        "collision": collision,
        "left_thruster": last_debug["tport"],
        "right_thruster": last_debug["tstbd"],
        "e_u": loop.ctrl.e_u,
        "e_r": loop.ctrl.e_r,
        "Ka_u": loop.ctrl.ka_u,
        "Ka_r": loop.ctrl.ka_r,
        "ye_reward": ye_reward,
        "angle_to_target_reward": angle_reward,
        "velocity_track_reward": velocity_track_reward,
        "delta_action_reward": delta_action_reward,
        "reward": reward,
    }
    return state, TimeStep(
        obs=obs, reward=reward,
        terminated=terminated, truncated=truncated, info=info,
    )

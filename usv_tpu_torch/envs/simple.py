"""``usv-simple`` as a batch-first functional core — port of ``usv_tpu/envs/simple.py``.

A first-order kinematic boat, a 128-ray sensor, a straight start->end path
with monotone progress, a dense shaped reward and fully domain-randomized
resets (reference ``gym_usv/envs/simple_env.py``; line cites below are the
reference's, as in the JAX module). Every tensor carries the env batch as its
first dimension; obstacle arrays have a fixed capacity and a validity mask.

Divergences from the JAX module (documented, not bugs):

* RNG: the per-env ``key`` leaf is gone. A reset is a pure transform of one
  ``(B, 16+3K+3P)`` uniform block (:func:`reset_from_uniform`, the exact
  layout of the JAX reset's single draw); :func:`reset` draws that block with
  ``torch.rand`` from an explicit ``torch.Generator`` on the state's device,
  owned by the rollout. The distributions are JAX's; the bit streams differ.
  Fed JAX's own block, the transform reproduces JAX's state.
* Everything else — the reference's divergences that the JAX module already
  documents (fresh-env zero sensor data at reset, the mask-based obstacle
  prune and slot-0 fallback, path obstacles in reserved tail slots) — is
  kept as it is.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import torch

from usv_tpu_torch.core.angles import wrap_angle
from usv_tpu_torch.core.geometry import closest_point_on_segment, cross_track_error
from usv_tpu_torch.envs.types import TimeStep, reset_from_generator
from usv_tpu_torch.ops.dispatch import sensor_raycast

TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class SimpleEnvConfig:
    """Static configuration: the JAX config's fields and defaults."""

    sensor_count: int = 128
    sensor_max_range: float = 100.0
    sensor_span: float = (2.0 / 3.0) * 2.0 * math.pi
    obstacle_cap: int = 32
    env_bound: float = 20.0  # world is [0, env_bound]^2 (reference :56)
    dt: float = 1.0 / 25.0
    max_episode_steps: int = 500  # TimeLimit (gym_usv/__init__.py:27)
    ignore_obstacles: bool = False
    # Reference raycast reduction (sorted-first-hit, :439-461) vs true min.
    strict_compat_raycast: bool = True
    # "auto": the CUDA kernel on CUDA tensors, the plain torch form on the
    # CPU; "pallas" forces the kernel, "xla" the plain form (ops/dispatch.py)
    raycast_backend: str = "auto"
    # Reward constants (reference :150-186)
    ye_k: float = 0.075
    collision_penalty: float = -20.0
    collision_sensor_threshold: float = 0.2
    # Extra obstacles placed along the path at reset (reference :276-288)
    path_obstacles: int = 0

    @property
    def obs_dim(self) -> int:
        return 15 + self.sensor_count

    @property
    def action_dim(self) -> int:
        return 2

    @property
    def action_low(self):
        # dU in [0.2, 1], dR in [-1, 1] (reference simple_env.py:30)
        return (0.2, -1.0)

    @property
    def action_high(self):
        return (1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class SimpleEnvState:
    position: torch.Tensor          # (B, 3) x, y, psi
    velocity: torch.Tensor          # (B, 3) u, v, r
    last_action: torch.Tensor       # (B, 3) smoothed [u, 0, r] action
    path_start: torch.Tensor        # (B, 2)
    path_end: torch.Tensor          # (B, 2)
    progress: torch.Tensor          # (B,)
    target_position: torch.Tensor   # (B, 2)
    max_action: torch.Tensor        # (B, 3)
    max_acceleration: torch.Tensor  # (B, 3)
    reference_velocity: torch.Tensor  # (B,)
    obs_xy: torch.Tensor            # (B, K, 2)
    obs_r: torch.Tensor             # (B, K)
    obs_mask: torch.Tensor          # (B, K) bool
    sensor_dist: torch.Tensor       # (B, R) last raycast distances
    step_count: torch.Tensor        # (B,) int32

    def replace(self, **changes) -> "SimpleEnvState":
        return dataclasses.replace(self, **changes)


@lru_cache(maxsize=None)
def _const(values: tuple, device) -> torch.Tensor:
    """A read-only float32 constant, made once per device (no per-step copy)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def n_uniform(cfg: SimpleEnvConfig) -> int:
    """Width of the uniform block one reset consumes."""
    return 16 + 3 * cfg.obstacle_cap + 3 * cfg.path_obstacles


def _sensor_sweep(cfg: SimpleEnvConfig, state: SimpleEnvState):
    """Boundary distances + raycast — reference :203-226.

    Returns (min boundary distance (B,), per-ray distances (B, R)). With
    ``ignore_obstacles`` nothing is cast: JAX computes the ray-cast and
    overwrites it, and XLA drops the unused result; eager torch would launch
    it all the same.
    """
    if cfg.ignore_obstacles:
        # reference :222-224: distances forced clear
        B, dtype, device = state.position.shape[0], state.position.dtype, state.position.device
        return (torch.ones((B,), dtype=dtype, device=device),
                torch.full((B, cfg.sensor_count), cfg.sensor_max_range, dtype=dtype, device=device))
    n = state.obs_xy - state.position[:, None, :2]
    boundary = torch.hypot(n[..., 0], n[..., 1]) - state.obs_r
    dist = sensor_raycast(
        state.position, state.obs_xy, state.obs_r, state.obs_mask, boundary,
        cfg.sensor_count, cfg.sensor_max_range, cfg.sensor_span,
        strict_compat=cfg.strict_compat_raycast,
        backend=cfg.raycast_backend,
    )
    return torch.where(state.obs_mask, boundary, math.inf).amin(-1), dist


def _angle_to_target(state: SimpleEnvState):
    delta = state.target_position - state.position[:, :2]
    return wrap_angle(torch.atan2(delta[:, 1], delta[:, 0]) - state.position[:, 2])


def _target_state(cfg: SimpleEnvConfig, state: SimpleEnvState):
    """[angle, distance, ye, ref_vel] / norms — reference :72-80; (B, 4)."""
    distance = torch.hypot(
        state.position[:, 0] - state.target_position[:, 0],
        state.position[:, 1] - state.target_position[:, 1],
    )
    angle = _angle_to_target(state)
    ye = cross_track_error(state.position[:, :2], state.path_start, state.path_end)
    norm = _const(
        (math.pi, math.hypot(cfg.env_bound, cfg.env_bound), 10.0, 10.0),
        state.position.device,
    )
    return torch.stack([angle, distance, ye, state.reference_velocity], dim=-1) / norm


def observe(cfg: SimpleEnvConfig, state: SimpleEnvState, action3) -> torch.Tensor:
    """The (B, 15 + R) observation — reference ``_get_obs`` :91-96."""
    sensor_state = state.sensor_dist / cfg.sensor_max_range
    target_state = _target_state(cfg, state)
    action_state = torch.stack([action3[:, 0], action3[:, 2]], dim=-1) / torch.stack(
        [state.max_action[:, 0], state.max_action[:, 2]], dim=-1
    )
    kinem = torch.cat([state.max_action / 10.0, state.max_acceleration / 10.0], dim=-1)
    return torch.cat(
        [state.velocity / 10.0, target_state, action_state, kinem, sensor_state], dim=-1
    )


def compute_reward(cfg: SimpleEnvConfig, state: SimpleEnvState, action3):
    """Dense shaped reward — reference ``_get_reward`` :150-201, effective
    terms only (ye: max-of-exponentials :167-170; delta_action: linear :176;
    angle_action: zero :178). Returns (reward (B,), info dict)."""
    min_sensor = state.sensor_dist.amin(-1)
    if cfg.ignore_obstacles:
        colision_reward = torch.zeros_like(min_sensor)
    else:
        colision_reward = torch.where(
            min_sensor < cfg.collision_sensor_threshold, cfg.collision_penalty, 0.0
        )

    delta_action = torch.abs(state.last_action - action3)
    angle = _angle_to_target(state)
    ye = cross_track_error(state.position[:, :2], state.path_start, state.path_end)

    ye_reward = torch.maximum(
        torch.exp(-torch.abs(ye / cfg.ye_k)),
        torch.exp(-torch.square(ye / cfg.ye_k)),
    )
    angle_to_target_reward = torch.exp(-torch.abs(angle))
    delta_action_sum = delta_action.sum(-1)
    delta_action_reward = -(delta_action_sum / 2.0) * 0.15
    velocity_track_reward = (
        torch.exp(
            -torch.abs(
                torch.hypot(state.velocity[:, 0], state.velocity[:, 1])
                - state.reference_velocity
            )
        )
        * 0.05
    )

    reward = (
        colision_reward
        + ye_reward
        + angle_to_target_reward
        + velocity_track_reward
        + delta_action_reward
    )
    reward_info = {
        "ye_reward": ye_reward,
        "angle_to_target_reward": angle_to_target_reward,
        "angle_action_reward": torch.zeros_like(ye_reward),  # zeroed, ref :178
        "delta_action_reward": delta_action_reward,
        "delta_action": delta_action_sum,
        "velocity_track_reward": velocity_track_reward,
        "reference_velocity": state.reference_velocity,
        "reward_velocity": state.last_action[:, 0],
        "reference_velocity_error": state.last_action[:, 0] - state.reference_velocity,
    }
    return reward, reward_info


def _info(cfg: SimpleEnvConfig, state: SimpleEnvState, reward, action3):
    """Fixed-shape analog of reference ``_get_info`` :102-115."""
    zeros = torch.zeros_like(state.progress)
    return {
        "position": state.position,
        "velocity": state.velocity,
        "path_start": state.path_start,
        "path_end": state.path_end,
        "reward": reward,
        "action0": action3[:, 0],
        "action1": action3[:, 2],
        "left_thruster": zeros,
        "right_thruster": zeros,
        "ye": cross_track_error(state.position[:, :2], state.path_start, state.path_end),
        "angle_to_target": _target_state(cfg, state)[:, 0],
    }


def reset_info(cfg: SimpleEnvConfig, state: SimpleEnvState):
    """Post-reset info dict — the reference reset returns
    ``_get_info(-1, np.zeros(3))`` (simple_env.py:303-308)."""
    return _info(
        cfg, state, torch.full_like(state.progress, -1.0),
        torch.zeros_like(state.last_action),
    )


def box_muller(u1, u2):
    """Exact standard normals from a uniform pair; u1 in [0, 1) is guarded
    away from log(0) as the JAX reset does."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-38)))
    return r * torch.cos(TWO_PI * u2), r * torch.sin(TWO_PI * u2)


def reset_from_uniform(cfg: SimpleEnvConfig, u: torch.Tensor) -> SimpleEnvState:
    """Domain-randomized reset — reference ``reset`` :228-308 — as a pure
    transform of a ``(B, n_uniform(cfg))`` float32 block of U[0, 1) draws.

    Layout (the JAX reset's, ``usv_tpu/envs/simple.py``): [0:14] scalars,
    [14:14+2K] obs_xy, [14+2K:14+3K] obs_r, [14+3K:16+3K] the fallback
    position, then P path-obstacle magnitudes and 2P jitter uniforms.
    """
    B, K, P = u.shape[0], cfg.obstacle_cap, cfg.path_obstacles
    if u.shape != (B, n_uniform(cfg)):
        raise ValueError(f"uniform block {tuple(u.shape)}, expected {(B, n_uniform(cfg))}")
    n_random = K - P
    half = cfg.env_bound / 2.0
    device = u.device

    n0, n1 = box_muller(u[:, 0], u[:, 1])
    path_start = torch.stack([n0, n1], dim=-1) * 0.5 + half
    heading = u[:, 2] * TWO_PI - math.pi
    position = torch.cat([path_start, heading[:, None]], dim=-1)

    angle = u[:, 3] * TWO_PI - math.pi
    dist = 100.0 + 10.0 * u[:, 4]
    direction = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
    path_end = path_start + direction * dist[:, None]

    target_position = u[:, 5:7] * cfg.env_bound
    velocity = u[:, 7:10] * 0.15

    max_u = 1.5 + 1.5 * u[:, 10]
    max_action = torch.stack([max_u, torch.zeros_like(max_u), 3.0 + 3.0 * u[:, 11]], dim=-1)
    reference_velocity = 0.75 + u[:, 12] * (max_u - 0.75)
    max_acceleration = _const((1.75, 0.0, 3.0), device).expand(B, 3)

    # randint(15, 30): floor of a uniform over 15 values (u < 1 so <= 29)
    obstacle_n = 15 + torch.floor(u[:, 13] * 15.0).to(torch.int32)
    obs_xy = u[:, 14:14 + 2 * K].reshape(B, K, 2) * cfg.env_bound
    obs_r = 0.15 + 0.35 * u[:, 14 + 2 * K:14 + 3 * K]
    fallback_xy = u[:, 14 + 3 * K:16 + 3 * K] * cfg.env_bound
    slot = torch.arange(K, device=device)
    obs_mask = slot < torch.clamp_max(obstacle_n, n_random)[:, None]

    if P > 0:
        # reset option 'place_obstacles_on_path' (reference :276-288):
        # normally jittered points along the path direction, in the last P
        # slots; bound is hypot(0, env_bound) = env_bound (reference :281)
        base = 16 + 3 * K
        mag = u[:, base:base + P] * cfg.env_bound
        j0, j1 = box_muller(u[:, base + P:base + 2 * P], u[:, base + 2 * P:base + 3 * P])
        line = path_start[:, None, :] + direction[:, None, :] * mag[:, :, None]
        path_obs = line + torch.stack([j0, j1], dim=-1)
        obs_xy = torch.cat([obs_xy[:, :n_random], path_obs], dim=1)
        obs_mask = obs_mask | (slot >= n_random)

    # Invalidate obstacles within 0.5 m of the start or the sampled target
    # (reference :260-268); path obstacles are exempt, as in the reference.
    d_pos = torch.hypot(obs_xy[..., 0] - position[:, 0:1], obs_xy[..., 1] - position[:, 1:2])
    d_tgt = torch.hypot(
        obs_xy[..., 0] - target_position[:, 0:1], obs_xy[..., 1] - target_position[:, 1:2]
    )
    is_random = slot < n_random
    near = (d_pos < 0.5) | (d_tgt < 0.5)
    keep = obs_mask & ~(near & is_random)
    # "Place one obstacle back in" if every random obstacle got deleted
    # (reference :270-274): slot 0 re-enabled at a fresh uniform position
    no_random = ~torch.any(keep & is_random, dim=-1)
    refill = no_random[:, None] & (slot == 0)
    obs_xy = torch.where(refill[..., None], fallback_xy[:, None, :], obs_xy)
    keep = keep | refill

    zeros = torch.zeros(B, dtype=torch.float32, device=device)
    return SimpleEnvState(
        position=position,
        velocity=velocity,
        last_action=torch.zeros((B, 3), dtype=torch.float32, device=device),
        path_start=path_start,
        path_end=path_end,
        progress=zeros,
        target_position=target_position,
        max_action=max_action,
        max_acceleration=max_acceleration,
        reference_velocity=reference_velocity,
        obs_xy=obs_xy,
        obs_r=obs_r,
        obs_mask=keep,
        sensor_dist=torch.zeros((B, cfg.sensor_count), dtype=torch.float32, device=device),
        step_count=torch.zeros(B, dtype=torch.int32, device=device),
    )


reset = reset_from_generator(reset_from_uniform, n_uniform)


def reset_obs(cfg: SimpleEnvConfig, state: SimpleEnvState) -> torch.Tensor:
    """The observation the reference returns from reset (:302): built with a
    zero action and the pre-step (uniform-sampled) target position."""
    return observe(cfg, state, torch.zeros_like(state.last_action))


def step(
    cfg: SimpleEnvConfig,
    state: SimpleEnvState,
    action,
    update_position: bool = True,
):
    """One 25 Hz step of every env — reference ``step`` :310-346, same op order.

    ``action`` is (B, 2) = (dU, dR) in the reference's action space. Returns
    ``(new_state, TimeStep)``.
    """
    action3 = torch.stack([action[:, 0], torch.zeros_like(action[:, 0]), action[:, 1]], dim=-1)
    action3 = state.max_action * action3

    if update_position:
        action3 = 0.8 * state.last_action + 0.2 * action3
        delta_v = torch.clamp(
            action3 - state.velocity, -state.max_acceleration, state.max_acceleration
        )
        velocity = torch.clamp(
            state.velocity + delta_v, -state.max_action, state.max_action
        )
        theta = state.position[:, 2]
        rotated_vel = torch.stack(
            [velocity[:, 0] * torch.cos(theta), velocity[:, 0] * torch.sin(theta), velocity[:, 2]],
            dim=-1,
        )
        position = state.position + rotated_vel * cfg.dt
        state = state.replace(position=position, velocity=velocity)

    # Guidance: lookahead'd closest point with monotone progress (:328, :139-148)
    target_position, progress = closest_point_on_segment(
        state.position[:, :2], state.path_start, state.path_end,
        state.progress, (0.005 / 10.0) * cfg.env_bound,
    )
    state = state.replace(target_position=target_position, progress=progress)

    # Sensors (:329)
    min_boundary, sensor_dist = _sensor_sweep(cfg, state)
    state = state.replace(sensor_dist=sensor_dist)

    if cfg.ignore_obstacles:
        terminated = torch.zeros_like(min_boundary, dtype=torch.bool)
    else:
        terminated = min_boundary < 0.05
    xy = state.position[:, :2]
    truncated = torch.any((xy > cfg.env_bound) | (xy < 0.0), dim=-1)
    # TimeLimit (max_episode_steps=500, gym_usv/__init__.py:27)
    step_count = state.step_count + 1
    truncated = truncated | (step_count >= cfg.max_episode_steps)

    # Observation uses the PREVIOUS action (reference :338)
    obs = observe(cfg, state, state.last_action)
    reward, reward_info = compute_reward(cfg, state, action3)
    info = _info(cfg, state, reward, action3)
    info.update(reward_info)

    state = state.replace(last_action=action3, step_count=step_count)
    return state, TimeStep(
        obs=obs,
        reward=reward,
        terminated=terminated,
        truncated=truncated,
        info=info,
    )

"""Plain reference of ``usv-simple`` (gym-usv ``gym_usv/envs/simple_env.py``):
a first-order kinematic boat at 25 Hz, a ray sensor, a straight start->end
path with monotone progress, the dense shaped reward, a 500-step time limit,
and a domain-randomized reset written as a transform of one block of U[0, 1)
draws.

A state is a dict of (B, ...) tensors under the names of the port's state
fields; ``cfg`` is the configuration file, whose ``env`` block is read. Every float
is computed in the dtype of the state it is given, so the same code serves
as the control in a lower precision.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.raycast import first_hit

TWO_PI = 2.0 * math.pi


def n_uniform(cfg) -> int:
    return 16 + 3 * cfg["env"]["obstacle_cap"]


def _const(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def cross_track(xy, p0, p1):
    ak = torch.atan2(p1[:, 1] - p0[:, 1], p1[:, 0] - p0[:, 0])
    return -(xy[:, 0] - p0[:, 0]) * torch.sin(ak) + (xy[:, 1] - p0[:, 1]) * torch.cos(ak)


def box_muller(u1, u2):
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-38)))
    return r * torch.cos(TWO_PI * u2), r * torch.sin(TWO_PI * u2)


def reset_from_uniform(cfg, u):
    """A fresh env per row of ``u`` (B, n_uniform): [0:14] scalars, then the
    obstacles' centres, radii and the fallback centre (simple_env.py:228-308)."""
    e = cfg["env"]
    if e["path_obstacles"]:
        raise ValueError("the reference covers path_obstacles = 0, as configured")
    B, K = u.shape[0], e["obstacle_cap"]
    bound = e["env_bound"]
    n0, n1 = box_muller(u[:, 0], u[:, 1])
    path_start = torch.stack([n0, n1], dim=-1) * 0.5 + bound / 2.0
    heading = u[:, 2] * TWO_PI - math.pi
    position = torch.cat([path_start, heading[:, None]], dim=-1)
    angle = u[:, 3] * TWO_PI - math.pi
    dist = 100.0 + 10.0 * u[:, 4]
    direction = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
    path_end = path_start + direction * dist[:, None]
    target = u[:, 5:7] * bound
    max_u = 1.5 + 1.5 * u[:, 10]
    max_action = torch.stack([max_u, torch.zeros_like(max_u), 3.0 + 3.0 * u[:, 11]], dim=-1)
    n_obstacles = 15 + torch.floor(u[:, 13] * 15.0).to(torch.int32)   # randint(15, 30)
    obs_xy = u[:, 14:14 + 2 * K].reshape(B, K, 2) * bound
    obs_r = 0.15 + 0.35 * u[:, 14 + 2 * K:14 + 3 * K]
    fallback = u[:, 14 + 3 * K:16 + 3 * K] * bound
    slot = torch.arange(K, device=u.device)
    mask = slot < torch.clamp_max(n_obstacles, K)[:, None]
    # obstacles within 0.5 m of the start or the target are removed; if none
    # is left, slot 0 comes back at the fallback centre (:260-274)
    d_pos = torch.hypot(obs_xy[..., 0] - position[:, 0:1], obs_xy[..., 1] - position[:, 1:2])
    d_tgt = torch.hypot(obs_xy[..., 0] - target[:, 0:1], obs_xy[..., 1] - target[:, 1:2])
    keep = mask & ~((d_pos < 0.5) | (d_tgt < 0.5))
    refill = ~torch.any(keep, dim=-1)[:, None] & (slot == 0)
    obs_xy = torch.where(refill[..., None], fallback[:, None, :], obs_xy)
    zeros = torch.zeros_like(u[:, 0])
    return {
        "position": position,
        "velocity": u[:, 7:10] * 0.15,
        "last_action": torch.zeros_like(u[:, :3]),
        "path_start": path_start,
        "path_end": path_end,
        "progress": zeros,
        "target_position": target,
        "max_action": max_action,
        "max_acceleration": _const((1.75, 0.0, 3.0), u).expand(B, 3),
        "reference_velocity": 0.75 + u[:, 12] * (max_u - 0.75),
        "obs_xy": obs_xy,
        "obs_r": obs_r,
        "obs_mask": keep | refill,
        "sensor_dist": torch.zeros((B, e["sensor_count"]), dtype=u.dtype, device=u.device),
        "step_count": torch.zeros(B, dtype=torch.int32, device=u.device),
    }


def _angle_to_target(s):
    delta = s["target_position"] - s["position"][:, :2]
    return wrap(torch.atan2(delta[:, 1], delta[:, 0]) - s["position"][:, 2])


def observe(cfg, s, action3):
    """(B, 15 + R): velocity, target state, action, limits, sensors (:91-96)."""
    e = cfg["env"]
    pos = s["position"]
    distance = torch.hypot(pos[:, 0] - s["target_position"][:, 0],
                           pos[:, 1] - s["target_position"][:, 1])
    ye = cross_track(pos[:, :2], s["path_start"], s["path_end"])
    norm = _const((math.pi, math.hypot(e["env_bound"], e["env_bound"]), 10.0, 10.0), pos)
    target = torch.stack([_angle_to_target(s), distance, ye, s["reference_velocity"]], -1) / norm
    action = torch.stack([action3[:, 0], action3[:, 2]], -1) / torch.stack(
        [s["max_action"][:, 0], s["max_action"][:, 2]], -1)
    kinem = torch.cat([s["max_action"] / 10.0, s["max_acceleration"] / 10.0], -1)
    return torch.cat([s["velocity"] / 10.0, target, action, kinem,
                      s["sensor_dist"] / e["sensor_max_range"]], -1)


def reset_obs(cfg, s):
    return observe(cfg, s, torch.zeros_like(s["last_action"]))


def reward(cfg, s, action3):
    """The reward's effective terms (:150-201)."""
    e = cfg["env"]
    collision = torch.where(s["sensor_dist"].amin(-1) < e["collision_sensor_threshold"],
                            e["collision_penalty"], 0.0).to(action3.dtype)
    delta_action = torch.abs(s["last_action"] - action3)
    ye = cross_track(s["position"][:, :2], s["path_start"], s["path_end"])
    ye_r = torch.maximum(torch.exp(-torch.abs(ye / e["ye_k"])),
                         torch.exp(-torch.square(ye / e["ye_k"])))
    angle_r = torch.exp(-torch.abs(_angle_to_target(s)))
    speed = torch.hypot(s["velocity"][:, 0], s["velocity"][:, 1])
    velocity_r = torch.exp(-torch.abs(speed - s["reference_velocity"])) * 0.05
    return collision + ye_r + angle_r + velocity_r + (-(delta_action.sum(-1) / 2.0) * 0.15)


def step(cfg, s, action):
    """One step of every row (simple_env.py:310-346) -> (state, outputs)."""
    e = cfg["env"]
    s = dict(s)
    a0 = action[:, 0]
    action3 = s["max_action"] * torch.stack([a0, torch.zeros_like(a0), action[:, 1]], -1)
    action3 = 0.8 * s["last_action"] + 0.2 * action3
    dv = torch.clamp(action3 - s["velocity"], -s["max_acceleration"], s["max_acceleration"])
    velocity = torch.clamp(s["velocity"] + dv, -s["max_action"], s["max_action"])
    theta = s["position"][:, 2]
    moved = torch.stack([velocity[:, 0] * torch.cos(theta), velocity[:, 0] * torch.sin(theta),
                         velocity[:, 2]], -1)
    s["position"] = s["position"] + moved * e["dt"]
    s["velocity"] = velocity
    # guidance: the projection on the path plus a lookahead, never backwards
    d = s["path_end"] - s["path_start"]
    det = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
    rel = s["position"][:, :2] - s["path_start"]
    a = (d[:, 1] * rel[:, 1] + d[:, 0] * rel[:, 0]) / det
    a = a + (0.005 / 10.0) * e["env_bound"]
    a = torch.clamp(torch.maximum(a, s["progress"]), max=1.0)
    s["target_position"] = s["path_start"] + a[:, None] * d
    s["progress"] = a
    n = s["obs_xy"] - s["position"][:, None, :2]
    boundary = torch.hypot(n[..., 0], n[..., 1]) - s["obs_r"]
    s["sensor_dist"] = first_hit(s["position"], s["obs_xy"], s["obs_r"], s["obs_mask"], boundary,
                                 e["sensor_count"], e["sensor_max_range"], e["sensor_span"])
    terminated = torch.where(s["obs_mask"], boundary, math.inf).amin(-1) < 0.05
    xy = s["position"][:, :2]
    step_count = s["step_count"] + 1
    truncated = (torch.any((xy > e["env_bound"]) | (xy < 0.0), dim=-1)
                 | (step_count >= e["max_episode_steps"]))
    obs = observe(cfg, s, s["last_action"])     # the previous action (:338)
    r = reward(cfg, s, action3)
    s["last_action"] = action3
    s["step_count"] = step_count
    return s, {"obs": obs, "reward": r, "terminated": terminated, "truncated": truncated}

"""Plain ray-cast sensor of the reference envs: first hit in nearest-boundary
order, as masked (B, R, K) tensor ops in the inputs' dtype.

Geometry (gym-usv's ``compute_sensor_measurment``): ray i points at
``psi - 2*pi/3 + i * span / R``; an obstacle is hit when it lies ahead of the
boat and the ray's line meets its disc; of the obstacles a ray hits, the one
with the least boundary distance (centre distance minus radius) is taken, and
the reading is the distance to its near edge, or ``max_range`` without a hit.
The order of operations is the one whose float32 results the port's
documentation gives for its kernel, so that a sound program reads the same
numbers to rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FIRST_RAY = -2.0 * math.pi / 3.0


def ray_offsets(sensor_count: int, sensor_span: float, dtype, device):
    """(cos, sin) of each ray's offset from the heading, computed in float64
    on the host and cast: each (R,)."""
    base = FIRST_RAY + np.arange(sensor_count) * (sensor_span / sensor_count)
    table = torch.tensor(np.stack([np.cos(base), np.sin(base)]), dtype=dtype, device=device)
    return table[0], table[1]


def first_hit(position, obs_xy, obs_r, obs_mask, boundary, sensor_count: int,
              max_range: float, sensor_span: float):
    """Ray distances (B, R). ``position`` (B, 3) x, y, psi; ``obs_xy`` (B, K, 2);
    ``obs_r``, ``obs_mask``, ``boundary`` (B, K)."""
    ray_c, ray_s = ray_offsets(sensor_count, sensor_span, position.dtype, position.device)
    x, y, psi = position[:, 0:1], position[:, 1:2], position[:, 2:3]
    cp, sp = torch.cos(psi), torch.sin(psi)
    c = (cp * ray_c - sp * ray_s)[:, :, None]        # (B, R, 1)
    s = (sp * ray_c + cp * ray_s)[:, :, None]
    nx = (obs_xy[..., 0] - x)[:, None, :]            # (B, 1, K)
    ny = (obs_xy[..., 1] - y)[:, None, :]
    r = obs_r[:, None, :]
    along = c * nx + s * ny                          # (B, R, K)
    # r^2 - lateral^2, with lateral^2 = |n|^2 - along^2
    delta = (r * r - (nx * nx + ny * ny)) + along * along
    # a hit ahead and inside max_range: along - sqrt(delta) < max_range
    beyond = torch.clamp_min(along - max_range, 0.0)
    hit = (along >= 0.0) & (delta >= beyond * beyond)
    key = torch.where(obs_mask, boundary, math.inf)[:, None, :]
    cand = torch.where(hit & (key < math.inf), key, math.inf)
    best = cand.amin(-1, keepdim=True)
    idx = cand.argmin(-1, keepdim=True)              # the first slot on a tie
    picked = torch.clamp_max(along.gather(-1, idx) - torch.sqrt(delta.gather(-1, idx)), max_range)
    return torch.where(torch.isfinite(best), picked, max_range)[..., 0]

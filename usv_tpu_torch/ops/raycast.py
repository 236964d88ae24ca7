"""Ray-cast obstacle sensor, plain torch form — port of ``usv_tpu/ops/raycast.py``.

The whole (rays x obstacles) interaction is one masked elementwise block and
a min-reduction over the obstacle axis: shapes ``(..., R, K)``. This is the
form the CPU path runs (as JAX's dispatch picks its XLA form on the CPU);
CUDA tensors go to the hand-written kernel instead (``ops/raycast_cuda.py``).

Geometry (the reference's): ray i points at ``psi - 2*pi/3 + i * resolution``;
obstacle j in the ray frame is ``x' = c nx + s ny``, ``y' = s nx - c ny``; the
ray hits j iff ``x' >= 0`` and ``r^2 - y'^2 >= 0``, at ``x' - sqrt(...)``.

* :func:`raycast` — true minimum over valid obstacles.
* :func:`raycast_first_hit_compat` — the reference loop's first intersecting
  obstacle in boundary-distance order, as two masked min-reductions.

Obstacles use a fixed capacity and a validity mask: invalid slots never hit.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

DEFAULT_SPAN = (2.0 / 3.0) * 2.0 * math.pi
FIRST_RAY = -2.0 * math.pi / 3.0


def sensor_angles(psi, sensor_count: int, sensor_span: float = DEFAULT_SPAN):
    """World-frame ray angles ``psi - 2*pi/3 + i * resolution``, shape (..., R)."""
    resolution = sensor_span / sensor_count
    offsets = FIRST_RAY + torch.arange(
        sensor_count, dtype=torch.float32, device=psi.device
    ) * resolution
    return psi[..., None] + offsets


@lru_cache(maxsize=64)
def ray_table(sensor_count: int, sensor_span: float, dtype, device):
    """Per-ray (cos, sin) of the ray offsets, computed in float64 on the host
    and cast to ``dtype``: shape (2, R). Read-only; shared by every call."""
    resolution = sensor_span / sensor_count
    base = FIRST_RAY + np.arange(sensor_count) * resolution
    return torch.tensor(np.stack([np.cos(base), np.sin(base)]), dtype=dtype, device=device)


def _ray_frame_hits(position, obs_xy, obs_r, obs_mask, sensor_count, sensor_span):
    """Shared geometry: (dist, valid) of shape (..., R, K)."""
    psi = position[..., 2]
    # cos/sin of (psi + ray offset) by the addition identity, as JAX does
    ray_c, ray_s = ray_table(sensor_count, float(sensor_span), position.dtype, position.device)
    cp = torch.cos(psi)[..., None]
    sp = torch.sin(psi)[..., None]
    c = cp * ray_c - sp * ray_s  # (..., R)
    s = sp * ray_c + cp * ray_s

    n = obs_xy - position[..., None, :2]  # (..., K, 2)
    nx, ny = n[..., 0], n[..., 1]
    x = c[..., :, None] * nx[..., None, :] + s[..., :, None] * ny[..., None, :]
    y = s[..., :, None] * nx[..., None, :] - c[..., :, None] * ny[..., None, :]

    r = obs_r[..., None, :]
    delta = r * r - y * y
    dist = x - torch.sqrt(torch.clamp_min(delta, 0.0))
    valid = (x >= 0.0) & (delta >= 0.0) & obs_mask[..., None, :]
    return dist, valid


def raycast(
    position,
    obs_xy,
    obs_r,
    obs_mask,
    sensor_count: int,
    sensor_max_range: float,
    sensor_span: float = DEFAULT_SPAN,
):
    """True-min lidar distances, shape (..., R), clamped to max_range.

    position (..., 3) x, y, psi; obs_xy (..., K, 2); obs_r, obs_mask (..., K).
    """
    dist, valid = _ray_frame_hits(
        position, obs_xy, obs_r, obs_mask, sensor_count, sensor_span
    )
    dist = torch.where(valid, dist, sensor_max_range)
    return torch.clamp_max(dist.amin(dim=-1), sensor_max_range)


def raycast_first_hit_compat(
    position,
    obs_xy,
    obs_r,
    obs_mask,
    sensor_count: int,
    sensor_max_range: float,
    sensor_span: float = DEFAULT_SPAN,
    boundary_distance=None,
):
    """First hit in nearest-boundary-first order (the reference loop).

    "First intersecting obstacle in argsort(boundary) order" is "the valid hit
    with the least boundary distance", so two masked min-reductions replace
    the sort. ``boundary_distance`` (..., K) is the ordering key; it defaults
    to ``hypot(obs - boat) - r``.
    """
    dist, valid = _ray_frame_hits(
        position, obs_xy, obs_r, obs_mask, sensor_count, sensor_span
    )
    # the reference loop also skips hits at or beyond max_range
    valid = valid & (dist < sensor_max_range)

    if boundary_distance is None:
        n = obs_xy - position[..., None, :2]
        boundary_distance = torch.hypot(n[..., 0], n[..., 1]) - obs_r

    key = boundary_distance[..., None, :]  # (..., 1, K)
    best_key = torch.where(valid, key, math.inf).amin(dim=-1, keepdim=True)  # (..., R, 1)
    any_hit = torch.isfinite(best_key[..., 0])
    picked = torch.where(valid & (key == best_key), dist, math.inf).amin(dim=-1)
    return torch.where(any_hit, picked, sensor_max_range)

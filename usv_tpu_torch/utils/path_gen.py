"""Curved-path generation and obstacle placement along paths — port of
``usv_tpu/utils/path_gen.py``.

Random polar waypoints -> cumulative sum -> monotone cubic (PCHIP)
interpolation (reference ``gym_usv/utils/path_gen.py``). A path is a
:class:`PchipPath` of knot tensors whose LAST dimension runs over the N knots;
any leading dimensions are a batch of paths (``(B, N)`` for an env batch,
``(N,)`` for one path), so thousands of randomized paths are fitted and
evaluated in one call.

Divergences from the JAX module (documented, not bugs):

* The interval of a query is found by counting the knots at or below it and
  one ``gather`` per knot array. The JAX module selects the same knot values
  with a one-hot contraction, a layout choice for its hardware; both hand the
  cubic the identical knot values.
* :func:`pchip_derivative` is the analytic derivative of the Hermite cubic
  (the JAX module differentiates the evaluation with ``jax.grad``).
* Randomness: :func:`generate_path` and :func:`place_obstacles` draw from an
  explicit ``torch.Generator``; their transforms (:func:`path_from_draws`,
  :func:`obstacles_from_draws`) take the draws themselves.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PchipPath:
    """Monotone cubic Hermite path y(x) through (x, y) knots."""

    x: torch.Tensor  # (..., N) strictly increasing along the last dimension
    y: torch.Tensor  # (..., N)
    d: torch.Tensor  # (..., N) knot derivatives (Fritsch-Carlson)

    def __call__(self, xq):
        return pchip_eval(self, xq)

    def derivative(self, xq):
        return pchip_derivative(self, xq)


def pchip_fit(x, y) -> PchipPath:
    """Fritsch-Carlson monotone derivative estimation (PCHIP) over the last
    dimension; needs at least 3 knots."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    h = x[..., 1:] - x[..., :-1]
    delta = (y[..., 1:] - y[..., :-1]) / h

    # interior derivatives: weighted harmonic mean where slopes agree in sign
    h0, h1 = h[..., :-1], h[..., 1:]
    d0, d1 = delta[..., :-1], delta[..., 1:]
    w1 = 2.0 * h1 + h0
    w2 = h1 + 2.0 * h0
    harmonic = (w1 + w2) / (w1 / torch.where(d0 == 0, 1.0, d0) + w2 / torch.where(d1 == 0, 1.0, d1))
    interior = torch.where((d0 * d1) > 0, harmonic, 0.0)

    # endpoint derivatives: one-sided three-point formula, clipped for
    # monotonicity (standard pchip endpoint rule)
    def endpoint(h0, h1, d0, d1):
        d = ((2.0 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
        d = torch.where(torch.sign(d) != torch.sign(d0), 0.0, d)
        return torch.where(
            (torch.sign(d0) != torch.sign(d1)) & (torch.abs(d) > 3.0 * torch.abs(d0)),
            3.0 * d0,
            d,
        )

    d_start = endpoint(h[..., 0], h[..., 1], delta[..., 0], delta[..., 1])
    d_end = endpoint(h[..., -1], h[..., -2], delta[..., -1], delta[..., -2])
    d = torch.cat([d_start[..., None], interior, d_end[..., None]], dim=-1)
    return PchipPath(x=x, y=y, d=d)


def _segments(path: PchipPath, xq):
    """The knot values either side of each query. ``xq`` has the path's batch
    dimensions first and any further ones after them. Returns the queries as
    ``(..., Q)`` and six ``(..., Q)`` tensors x0, x1, y0, y1, d0, d1."""
    xq = torch.as_tensor(xq, dtype=torch.float32, device=path.x.device)
    batch = path.x.shape[:-1]
    if xq.shape[:len(batch)] != batch:
        raise ValueError(f"queries {tuple(xq.shape)} for a path batch {tuple(batch)}")
    n = path.x.shape[-1]
    q = xq.reshape(batch + (-1,))
    # interval index = (# knots <= xq) - 1, clipped to [0, n-2]: queries
    # outside the knots extrapolate the first or the last segment
    i = torch.clamp((q[..., None] >= path.x[..., None, :]).sum(-1) - 1, 0, n - 2)
    idx = torch.cat([i, i + 1], dim=-1)
    Q = q.shape[-1]
    out = [q]
    for knots in (path.x, path.y, path.d):
        both = knots.gather(-1, idx)
        out += [both[..., :Q], both[..., Q:]]
    return xq.shape, out


def pchip_eval(path: PchipPath, xq):
    """Evaluate the cubic Hermite at ``xq``: the path's batch dimensions, then
    any shape of queries per path."""
    shape, (q, x0, x1, y0, y1, d0, d1) = _segments(path, xq)
    h = x1 - x0
    t = (q - x0) / h
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t * t * (3 - 2 * t)
    h11 = t * t * (t - 1)
    return (h00 * y0 + h10 * h * d0 + h01 * y1 + h11 * h * d1).reshape(shape)


def pchip_derivative(path: PchipPath, xq):
    """dy/dx of the cubic Hermite at ``xq``, in closed form."""
    shape, (q, x0, x1, y0, y1, d0, d1) = _segments(path, xq)
    h = x1 - x0
    t = (q - x0) / h
    dh00 = 6 * t * (t - 1)          # d/dt of the four basis cubics
    dh10 = (3 * t - 1) * (t - 1)
    dh11 = t * (3 * t - 2)
    return (dh00 * (y0 - y1) / h + dh10 * d0 + dh11 * d1).reshape(shape)


def path_from_draws(angle_normals, length_normals, start_point,
                    angle_mean: float = 0.0, angle_std: float = 0.50,
                    length_mean: float = 3.0, length_std: float = 0.1):
    """:func:`generate_path` as a transform of its standard-normal draws
    ``(..., N)``. ``start_point`` is ``(..., 2)`` or a pair of floats."""
    angles = torch.clamp(angle_mean + angle_std * angle_normals,
                         -math.pi / 2 + 0.1, math.pi / 2 - 0.1)
    lengths = length_mean + length_std * length_normals
    steps = lengths[..., None] * torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    start = torch.as_tensor(start_point, dtype=torch.float32, device=steps.device)
    steps = torch.cat([start.expand(steps.shape[:-2] + (1, 2)), steps[..., 1:, :]], dim=-2)
    waypoints = torch.cumsum(steps, dim=-2)
    return pchip_fit(waypoints[..., 0], waypoints[..., 1]), waypoints


def generate_path(generator: torch.Generator, start_point, num_waypoints: int,
                  angle_mean: float = 0.0, angle_std: float = 0.50,
                  length_mean: float = 3.0, length_std: float = 0.1,
                  batch_shape=(), device="cpu"):
    """Random polar waypoints -> cumsum -> PCHIP (reference path_gen.py:6-14).

    Returns (path, waypoints) with waypoints ``(*batch_shape, N, 2)``.
    """
    normals = torch.randn((2, *batch_shape, num_waypoints), generator=generator,
                          dtype=torch.float32, device=device)
    return path_from_draws(normals[0], normals[1], start_point, angle_mean, angle_std,
                           length_mean, length_std)


def obstacles_from_draws(path: PchipPath, waypoints, base_u, displacement_normals,
                         offset_u, radius_normals,
                         obs_pos_std: float = 8.0, obs_rad_mean: float = 0.8,
                         obs_rad_std: float = 0.1, obs_min_size: float = 0.01):
    """:func:`place_obstacles` as a transform of its draws, each
    ``(..., num_obs)``: ``base_u`` and ``offset_u`` uniform in [0, 1), the
    other two standard normal."""
    min_x = waypoints[..., 0].amin(-1, keepdim=True)
    max_x = waypoints[..., 0].amax(-1, keepdim=True)
    base_x = base_u * (max_x - min_x) + min_x
    displacement = obs_pos_std * displacement_normals
    deriv_offset = offset_u * math.pi + math.pi
    deriv = pchip_derivative(path, base_x)
    # atan2 of the slope against the abscissa: the reference's own expression
    obs_angle = torch.atan2(deriv, base_x) + deriv_offset
    pos = torch.stack([base_x, pchip_eval(path, base_x)], dim=-1) + displacement[..., None] \
        * torch.stack([torch.cos(obs_angle), torch.sin(obs_angle)], dim=-1)
    radius = obs_rad_mean + obs_rad_std * radius_normals
    return torch.cat([pos, radius[..., None]], dim=-1), radius > obs_min_size


def place_obstacles(generator: torch.Generator, path: PchipPath, waypoints, num_obs: int,
                    obs_pos_std: float = 8.0, obs_rad_mean: float = 0.8,
                    obs_rad_std: float = 0.1, obs_min_size: float = 0.01):
    """Obstacles jittered around the path (reference path_gen.py:17-38).

    Returns (obstacles ``(..., num_obs, 3)`` = [x, y, r], valid mask
    ``(..., num_obs)``): a fixed shape with a mask instead of boolean
    filtering.
    """
    shape = (*path.x.shape[:-1], num_obs)
    device = path.x.device
    uniforms = torch.rand((2, *shape), generator=generator, dtype=torch.float32, device=device)
    normals = torch.randn((2, *shape), generator=generator, dtype=torch.float32, device=device)
    return obstacles_from_draws(path, waypoints, uniforms[0], normals[0], uniforms[1], normals[1],
                                obs_pos_std, obs_rad_mean, obs_rad_std, obs_min_size)


def simplified_lookahead(path: PchipPath, waypoints, current_x, lookahead):
    """x + lookahead clamped to the path start (reference path_gen.py:50-54)."""
    x = torch.maximum(current_x + lookahead, waypoints[..., 0, 0])
    return x, pchip_eval(path, x)


def plot_path(path: PchipPath, waypoints, obstacles, show: bool = True):
    """Matplotlib debug plot of one (unbatched) path with its waypoints and
    obstacles (reference path_gen.py:41-47). Host side, for debugging only.

    Returns the matplotlib axes (and shows the figure when ``show``).
    """
    import matplotlib.pyplot as plt

    waypoints = np.asarray(torch.as_tensor(waypoints).cpu())
    obstacles = np.asarray(torch.as_tensor(obstacles).cpu())
    xs = np.linspace(waypoints[0, 0], waypoints[-1, 0])
    ys = pchip_eval(path, torch.tensor(xs, dtype=torch.float32, device=path.x.device)).cpu().numpy()
    _, ax = plt.subplots()
    ax.plot(xs, ys)
    ax.scatter(waypoints[:, 0], waypoints[:, 1])
    if len(obstacles):
        ax.scatter(obstacles[:, 0], obstacles[:, 1], s=obstacles[:, 2] * 10)
    if show:
        plt.show()
    return ax

"""2-D geometry shared by guidance, sensors and envs — port of
``usv_tpu/core/geometry.py``. Elementwise over leading batch dimensions.

* cross-track error ``ye``          — reference ``simple_env.py:133-137``
* closest-point-with-progress      — reference ``simple_env.py:139-148``
* angle-to-point                   — reference ``usv_asmc_ca_env.py:405-409``
* _map/_normalize/_denormalize     — reference ``usv_asmc_ca_env.py:134-144``
* body/path rotations              — reference ``usv_asmc_env.py:376-401``
"""

import torch

from usv_tpu_torch.core.angles import wrap_angle


def rot2(angle):
    """2x2 rotation matrix R(angle); stacks along leading batch dims."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def body_to_world(vec_xy, angle):
    """Rotate body-frame (x, y) into world frame by heading ``angle``."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, y = vec_xy[..., 0], vec_xy[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def world_to_body(vec_xy, angle):
    """Rotate world-frame (x, y) into the body frame of heading ``angle``."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, y = vec_xy[..., 0], vec_xy[..., 1]
    return torch.stack([c * x + s * y, -s * x + c * y], dim=-1)


def cross_track_error(position_xy, path_start, path_end):
    """Signed lateral offset of ``position_xy`` from the start->end line:
    ye = -(x - x0) sin(ak) + (y - y0) cos(ak), ak the path direction."""
    a_k = torch.atan2(
        path_end[..., 1] - path_start[..., 1],
        path_end[..., 0] - path_start[..., 0],
    )
    return -(position_xy[..., 0] - path_start[..., 0]) * torch.sin(a_k) + (
        position_xy[..., 1] - path_start[..., 1]
    ) * torch.cos(a_k)


def closest_point_on_segment(position_xy, path_start, path_end, progress, lookahead):
    """Project onto the path line, add a lookahead, clamp to monotone progress.

    Returns ``(target_xy, new_progress)``; ``new_progress`` is the clamped
    parameter ``a`` along start->end (reference simple_env.py:139-148).
    """
    d = path_end - path_start
    det = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    rel = position_xy - path_start
    a = (d[..., 1] * rel[..., 1] + d[..., 0] * rel[..., 0]) / det
    a = a + lookahead
    # clip(a, progress, 1): lower bound first, then the upper, as jnp.clip
    a = torch.clamp(torch.maximum(a, progress), max=1.0)
    return path_start + a[..., None] * d, a


def angle_to_point(position_xy, heading, target_xy):
    """Bearing of ``target_xy`` relative to a boat at ``position_xy``/``heading``."""
    delta = target_xy - position_xy
    return wrap_angle(torch.atan2(delta[..., 1], delta[..., 0]) - heading)


def map_range(x, in_min, in_max, out_min, out_max):
    """Linear range remap; reference usv_asmc_ca_env.py:134-136."""
    return (x - in_min) * (out_max - out_min) / (in_max - in_min) + out_min


def normalize_val(x, in_min, in_max):
    """Map [in_min, in_max] -> [-1, 1]."""
    return map_range(x, in_min, in_max, -1.0, 1.0)


def denormalize_val(x, out_min, out_max):
    """Map [-1, 1] -> [out_min, out_max]."""
    return map_range(x, -1.0, 1.0, out_min, out_max)

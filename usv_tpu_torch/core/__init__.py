"""Angle and 2-D geometry math shared by guidance, sensors and envs."""

from usv_tpu_torch.core.angles import wrap_angle, wrap_angle_once
from usv_tpu_torch.core.geometry import (
    angle_to_point,
    body_to_world,
    closest_point_on_segment,
    cross_track_error,
    denormalize_val,
    map_range,
    normalize_val,
    rot2,
    world_to_body,
)

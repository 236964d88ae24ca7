"""Angle wrapping primitives — port of ``usv_tpu/core/angles.py``.

* :func:`wrap_angle`: atan2-style wrap to (-pi, pi] (reference
  ``simple_env.py:63-65``), the default everywhere.
* :func:`wrap_angle_once`: the legacy single-branch wrap (reference
  ``usv_asmc_env.py:124``), only correct for |a| < 3*pi.

Both are elementwise over tensors of any shape.
"""

import math

import torch


def wrap_angle(angle):
    """Wrap to (-pi, pi] via atan2(sin, cos). Reference simple_env.py:63-65."""
    return torch.atan2(torch.sin(angle), torch.cos(angle))


def wrap_angle_once(angle):
    """Subtract one full turn if |angle| > pi (reference usv_asmc_env.py:124);
    differs from :func:`wrap_angle` for |a| >= 3*pi and at |a| == pi."""
    a = torch.abs(angle)
    return torch.where(a > math.pi, torch.sign(angle) * (a - 2.0 * math.pi), angle)

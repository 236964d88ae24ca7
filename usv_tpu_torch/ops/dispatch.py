"""Single ray-cast entry point used by the envs: backend and semantics
dispatch — port of ``usv_tpu/ops/dispatch.py``.

Backends keep JAX's names so configs carry over:

* ``"auto"``: the CUDA kernel for CUDA tensors, the plain torch form
  (``ops/raycast.py``) for CPU tensors — as JAX picks its XLA form on the CPU.
* ``"pallas"``: the CUDA kernel; raises on CPU tensors.
* ``"xla"``: the plain torch form on any device.
"""

from __future__ import annotations

from usv_tpu_torch.ops.raycast import raycast, raycast_first_hit_compat
from usv_tpu_torch.ops.raycast_cuda import raycast_cuda

BACKENDS = ("auto", "pallas", "xla")


def resolve_backend(backend: str, device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"raycast backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "pallas" if device.type == "cuda" else "xla"
    return backend


def sensor_raycast(
    position,
    obs_xy,
    obs_r,
    obs_mask,
    boundary,
    sensor_count: int,
    sensor_max_range: float,
    sensor_span: float,
    strict_compat: bool = True,
    backend: str = "auto",
):
    """Batched ray distances (B, R) with the configured backend and semantics.

    ``boundary`` (B, K) is the first-hit ordering key (centre distance minus
    radius, per env flavor).
    """
    backend = resolve_backend(backend, position.device)
    if backend == "pallas":
        if position.device.type != "cuda":
            raise ValueError(
                f"raycast backend 'pallas' runs the CUDA kernel; got tensors on "
                f"{position.device} (use 'auto' or 'xla' on the CPU)"
            )
        return raycast_cuda(
            position, obs_xy, obs_r, obs_mask, sensor_count, sensor_max_range,
            sensor_span, boundary_distance=boundary, first_hit=strict_compat,
        )
    if strict_compat:
        return raycast_first_hit_compat(
            position, obs_xy, obs_r, obs_mask,
            sensor_count, sensor_max_range, sensor_span,
            boundary_distance=boundary,
        )
    return raycast(
        position, obs_xy, obs_r, obs_mask,
        sensor_count, sensor_max_range, sensor_span,
    )

"""The ray-cast CUDA kernel's launcher and its plain PyTorch version.

:func:`raycast_cuda` launches ``csrc/raycast.cu``, the port of the TPU kernel
``_batched_kernel`` (``usv_tpu/ops/raycast_pallas.py``), on PyTorch's current
stream. On CPU tensors it returns :func:`raycast_cuda_reference` instead, and
only then: on a CUDA tensor it launches the kernel or raises.

The function's bound is its bytes (556 in and 512 out per env at the
main-path shapes: 1.3 us), but a kernel that tests every valid ray-obstacle
pair is held by instruction issue long before: every one of its ~14 float32
operations per pair is unfused, to round as the plain version does. So the
design cuts pairs first, then spends on issue slots, shared-memory
instructions and registers. While a warp stages the envs it computes into
shared memory it drops the masked slots (a ballot and a popcount prefix keep
the order), packs each kept slot into one 16-byte ``float4``, computes the
heading's cos/sin once per env, and gives each group of neighbouring rays
its own list of the slots that lie inside the group's cone: a pair outside
is a miss in the plain version too, so no output bit changes. Then every
thread carries four rays (one where the launch is small) through a loop over
its lists only. Lanes are dealt over rays x envs, so narrow sensors (R=16,
32) share a warp between envs instead of idling lanes. There is no use here
for tensor cores (the product per pair has depth 2, and TF32 would break the
tangency bounds) or for TMA (nothing to hide behind a 1.3 us bytes bound).
The note at the top of ``csrc/raycast.cu`` has the details, ``PERF.md`` the
times.

:func:`raycast_cuda_reference` repeats the kernel's arithmetic — the
lateral fold, the squared-space hit test and its clamp, the strict
first-slot-wins order within and across the ``n_acc`` accumulators, every
option — as masked ``(B, R, K)`` tensor ops. The tests and ``chip_smoke.py``
hold the kernel against it; the main path never calls it on the card. It
runs in the inputs' dtype, so in float64 it serves as the tangency oracle.

Left as ``None``, ``defer_sqrt`` and ``n_acc`` take their defaults from the
environment variables ``USV_RAYCAST_DEFER_SQRT`` (default on) and
``USV_RAYCAST_NACC`` (default 1), read at the call as the JAX package reads
them. ``n_acc`` is clamped to ``[1, K]``; the kernel has 1 to 4 accumulators.
"""

from __future__ import annotations

import ctypes
import math
import os
from functools import lru_cache

import torch

from usv_tpu_torch import _build
from usv_tpu_torch.ops.raycast import DEFAULT_SPAN, FIRST_RAY, ray_table
from usv_tpu_torch.timing import counter

# the kernel's dynamic shared memory without an opt-in attribute
_SMEM_LIMIT = 48 * 1024


MAX_N_ACC = 4  # the kernel's instances (kMaxAcc in csrc/raycast.cu)


def _env_bool(name, default):
    v = os.environ.get(name, "").strip().lower()
    if not v:
        return default
    if v in ("1", "true", "on", "yes"):
        return True
    if v in ("0", "false", "off", "no"):
        return False
    raise ValueError(f"{name}={v!r}: expected a boolean (1/0/true/false)")


def _env_int(name, default):
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected an integer") from None


def resolve_options(n_acc, defer_sqrt, K):
    """``(n_acc, defer_sqrt)`` with ``None`` replaced by the environment's
    default, and ``n_acc`` clamped to ``[1, K]`` as the TPU launcher clamps it.
    More accumulators than the kernel has instances of raise."""
    if defer_sqrt is None:
        defer_sqrt = _env_bool("USV_RAYCAST_DEFER_SQRT", True)
    if n_acc is None:
        n_acc = _env_int("USV_RAYCAST_NACC", 1)
    n_acc = max(1, min(int(n_acc), K))
    if n_acc > MAX_N_ACC:
        raise ValueError(
            f"n_acc={n_acc}: the kernel has 1 to {MAX_N_ACC} accumulators"
        )
    return n_acc, bool(defer_sqrt)


@lru_cache(maxsize=None)
def _library():
    """The kernel's library, built on first use, with its C signatures."""
    lib = _build.load("raycast")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.usv_raycast_launch.argtypes = [p] * 7 + [i, i, i, f, f, i, i, i, i, i, p]
    lib.usv_raycast_launch.restype = ctypes.c_int
    lib.usv_raycast_smem_bytes.argtypes = [i, i, i]
    lib.usv_raycast_smem_bytes.restype = ctypes.c_longlong
    lib.usv_raycast_launch_empty.argtypes = [i, i, i, f, p]
    lib.usv_raycast_launch_empty.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _smem_bytes(B: int, R: int, K: int) -> int:
    """Dynamic shared memory a block of this launch takes."""
    return _library().usv_raycast_smem_bytes(B, R, K)


def _check_inputs(**tensors):
    """Shapes (B, 3), (B, K, 2), (B, K)...; float32 but the bool mask; one
    device; contiguous. Returns (B, K)."""
    position, obs_r = tensors["position"], tensors["obs_r"]
    B = position.shape[0]
    K = obs_r.shape[-1] if obs_r.dim() == 2 else -1
    expect = {
        "position": ((B, 3), torch.float32),
        "obs_xy": ((B, K, 2), torch.float32),
        "obs_r": ((B, K), torch.float32),
        "obs_mask": ((B, K), torch.bool),
        "boundary_distance": ((B, K), torch.float32),
    }
    device = position.device
    for name, t in tensors.items():
        shape, dtype = expect[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, position on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return B, K


def raycast_cuda(
    position,           # (B, 3) float32
    obs_xy,             # (B, K, 2) float32
    obs_r,              # (B, K) float32
    obs_mask,           # (B, K) bool
    sensor_count: int,
    sensor_max_range: float,
    sensor_span: float = DEFAULT_SPAN,
    boundary_distance=None,   # (B, K) float32
    first_hit: bool = True,
    n_acc=None,
    angle_addition: bool = True,
    fold_lateral: bool = True,
    defer_sqrt=None,
):
    """Batched ray-cast -> (B, R) float32: the TPU kernel's function and options.

    ``boundary_distance`` is the first-hit ordering key; it defaults to
    ``hypot(obs - boat) - r``.
    """
    B, K = _check_inputs(position=position, obs_xy=obs_xy, obs_r=obs_r, obs_mask=obs_mask)
    n_acc, defer_sqrt = resolve_options(n_acc, defer_sqrt, K)
    if boundary_distance is None:
        n = obs_xy - position[:, None, :2]
        boundary_distance = torch.hypot(n[..., 0], n[..., 1]) - obs_r
    _check_inputs(position=position, obs_r=obs_r, boundary_distance=boundary_distance)
    if position.device.type == "cpu":
        return raycast_cuda_reference(
            position, obs_xy, obs_r, obs_mask, sensor_count, sensor_max_range,
            sensor_span, boundary_distance, first_hit, n_acc, angle_addition,
            fold_lateral, defer_sqrt,
        )
    if position.device.type != "cuda":
        raise ValueError(f"raycast_cuda: unsupported device {position.device}")

    if 2 * B * max(K, sensor_count) >= 2**31:
        raise ValueError(f"raycast_cuda: B={B} envs exceed the kernel's 32-bit indices")
    # a block's rows of shared memory: one float4 per obstacle slot per list
    if _smem_bytes(B, sensor_count, K) > _SMEM_LIMIT:
        raise ValueError(f"raycast_cuda: K={K} obstacles exceed the kernel's shared memory")
    ray_cs = ray_table(sensor_count, float(sensor_span), torch.float32, position.device)
    out = torch.empty((B, sensor_count), dtype=torch.float32, device=position.device)
    with torch.cuda.device(position.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().usv_raycast_launch(
            position.data_ptr(), obs_xy.data_ptr(), obs_r.data_ptr(),
            obs_mask.view(torch.uint8).data_ptr(), boundary_distance.data_ptr(),
            ray_cs.data_ptr(), out.data_ptr(),
            B, sensor_count, K, float(sensor_max_range),
            float(sensor_span / sensor_count),
            int(first_hit), int(defer_sqrt), int(fold_lateral),
            int(angle_addition), int(n_acc), stream,
        )
    if err != 0:
        raise RuntimeError(f"raycast kernel launch failed: CUDA error {err}")
    counter.launched()
    return out


def launch_empty_grid(B: int, sensor_count: int, K: int, sensor_span: float = DEFAULT_SPAN):
    """Launch a kernel that does nothing on the grid :func:`raycast_cuda`
    takes at these shapes, on PyTorch's current stream: a measurement's floor,
    which no path of the port calls and the launch counter does not count."""
    with torch.cuda.device(torch.cuda.current_device()):
        err = _library().usv_raycast_launch_empty(
            B, sensor_count, K, float(sensor_span / sensor_count),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def raycast_cuda_reference(
    position,
    obs_xy,
    obs_r,
    obs_mask,
    sensor_count: int,
    sensor_max_range: float,
    sensor_span: float = DEFAULT_SPAN,
    boundary_distance=None,
    first_hit: bool = True,
    n_acc=None,
    angle_addition: bool = True,
    fold_lateral: bool = True,
    defer_sqrt=None,
):
    """The kernel's arithmetic as masked (B, R, K) tensor ops, in the inputs'
    dtype. Same arguments and result as :func:`raycast_cuda`."""
    K = obs_r.shape[-1]
    n_acc, defer_sqrt = resolve_options(n_acc, defer_sqrt, K)
    if first_hit and n_acc > 1:
        # accumulator a takes slots a, a + n_acc, ... and the accumulators
        # merge in order with a strict <: the first least key in this order
        # of the slots wins
        order = torch.tensor([k for a in range(n_acc) for k in range(a, K, n_acc)],
                             device=position.device)
        obs_xy, obs_r, obs_mask = obs_xy[:, order], obs_r[:, order], obs_mask[:, order]
        if boundary_distance is not None:
            boundary_distance = boundary_distance[:, order]
    dtype, device = position.dtype, position.device
    max_range = float(sensor_max_range)
    resolution = sensor_span / sensor_count
    x, y, psi = position[:, 0:1], position[:, 1:2], position[:, 2:3]  # (B, 1)
    if angle_addition:
        ray_c, ray_s = ray_table(sensor_count, float(sensor_span), dtype, device)
        cp, sp = torch.cos(psi), torch.sin(psi)
        c = cp * ray_c - sp * ray_s  # (B, R)
        s = sp * ray_c + cp * ray_s
    else:
        ray = torch.arange(sensor_count, dtype=dtype, device=device)
        angles = (psi + FIRST_RAY) + ray * resolution
        c, s = torch.cos(angles), torch.sin(angles)

    nx = (obs_xy[..., 0] - x)[:, None, :]  # (B, 1, K)
    ny = (obs_xy[..., 1] - y)[:, None, :]
    r = obs_r[:, None, :]
    c, s = c[:, :, None], s[:, :, None]     # (B, R, 1)
    xk = c * nx + s * ny                    # (B, R, K)
    if fold_lateral:
        delta = (r * r - (nx * nx + ny * ny)) + xk * xk
    else:
        yk = s * nx - c * ny
        delta = r * r - yk * yk

    if not first_hit:
        dist = xk - torch.sqrt(torch.clamp_min(delta, 0.0))
        valid = (xk >= 0.0) & (delta >= 0.0) & obs_mask[:, None, :]
        return torch.clamp_max(torch.where(valid, dist, max_range).amin(-1), max_range)

    if boundary_distance is None:
        n = obs_xy - position[:, None, :2]
        boundary_distance = torch.hypot(n[..., 0], n[..., 1]) - obs_r
    key = torch.where(obs_mask, boundary_distance, math.inf)[:, None, :]
    if defer_sqrt:
        t = torch.clamp_min(xk - max_range, 0.0)
        hit = (xk >= 0.0) & (delta >= t * t)
    else:
        dist = xk - torch.sqrt(delta)  # NaN on a miss fails the range test
        hit = (xk >= 0.0) & (dist < max_range)
    # the kernel's strict `key < best` over ascending slots: the least key
    # wins, the first slot on a tie; +inf and NaN keys never win
    cand = torch.where(hit & (key < math.inf), key, math.inf)
    best_key = cand.amin(-1, keepdim=True)
    idx = cand.argmin(-1, keepdim=True)  # first occurrence of the minimum
    if defer_sqrt:
        bx, bd = xk.gather(-1, idx), delta.gather(-1, idx)
        picked = torch.clamp_max(bx - torch.sqrt(bd), max_range)
    else:
        picked = dist.gather(-1, idx)
    return torch.where(torch.isfinite(best_key), picked, max_range)[..., 0]

"""The chip's peaks and the operation and byte counts of the ray-cast kernel,
from its shapes and its inputs, never from its implementation.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 at
3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.

The ray-cast (``usv_tpu_torch/csrc/raycast.cu``) reads each env's pose, its
K obstacles' centres, radii, mask bytes and boundary keys once, and writes R
float32 distances. Its least work is ``OPS_PER_PAIR`` float32 operations on
each ray-obstacle pair where the ray's line meets the obstacle's disc ahead
of the boat (every other pair is a miss whatever its numbers) and
``OPS_PER_SLOT`` on each valid obstacle slot to look at it once.
"""

from __future__ import annotations

import torch

from benchmark.reference.raycast import ray_offsets

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# xk 3, delta 2, t 2, t*t 1, three compares, three selects
OPS_PER_PAIR = 14
# nx, ny, q = r*r - (nx*nx + ny*ny), the mask test
OPS_PER_SLOT = 8


def raycast_bytes(B: int, R: int, K: int) -> int:
    """Bytes in and out of one launch: pose (3 float32), per slot a centre
    (2), a radius (1), a mask byte and a boundary key (1); R distances out."""
    return B * (3 * 4 + K * 2 * 4 + K * 4 + K * 1 + K * 4) + B * R * 4


def needed_pairs(position, obs_xy, obs_r, obs_mask, sensor_count: int, sensor_span: float) -> int:
    """Ray-obstacle pairs these inputs need evaluated: a valid obstacle whose
    disc the ray's line meets ahead of the boat."""
    ray_c, ray_s = ray_offsets(sensor_count, sensor_span, torch.float32, position.device)
    cp, sp = torch.cos(position[:, 2:3]), torch.sin(position[:, 2:3])
    c = (cp * ray_c - sp * ray_s)[:, :, None]
    s = (sp * ray_c + cp * ray_s)[:, :, None]
    n = (obs_xy - position[:, None, :2])[:, None]
    along = c * n[..., 0] + s * n[..., 1]
    lateral = s * n[..., 0] - c * n[..., 1]
    r = obs_r[:, None, :]
    return int(((along >= 0) & (lateral * lateral <= r * r) & obs_mask[:, None, :]).sum())


def raycast_least_seconds(B: int, R: int, K: int, needed: int, valid_slots: int) -> dict:
    """The least time of one launch: the larger of its bytes over the peak
    bandwidth and its needed operations over the float32 peak."""
    bytes_s = raycast_bytes(B, R, K) / PEAK_BYTES_PER_S
    ops_s = (OPS_PER_PAIR * needed + OPS_PER_SLOT * valid_slots) / PEAK_F32_PER_S
    return {"seconds": max(bytes_s, ops_s), "bytes_s": bytes_s, "ops_s": ops_s,
            "bound_by": "operations" if ops_s > bytes_s else "bytes"}


def _macs(layers, skip_first=False):
    """Multiply-adds of a chain of (in, out) products over one row: the
    forward pass, or a backward's weight gradients, or (``skip_first``) its
    input gradients where the chain's own input needs none."""
    return sum(n_in * n_out for n_in, n_out in layers[1 if skip_first else 0:])


def sac_round_flops(config: dict) -> float:
    """Matrix FLOPs of one steady round of the ``sac_train`` traffic: a
    forward product is 2 FLOPs a multiply-add, and a backward pass computes
    only the gradients the update needs (weight gradients of the network it
    steps, input gradients where a gradient flows on), 2 FLOPs a multiply-add
    each. Elementwise work and recomputation are not counted. Collect steps
    are the policy's (the warm-up's uniform actions come only in the first
    round, in set-up)."""
    L = config["learner"]
    obs, act = config["obs_dim"] * L["frame_stack"], len(config["action_low"])
    h = L["hidden"]
    trunk = list(zip([obs, *h[:-1]], h))
    head = [(h[-1], act)]
    sample = trunk + head + head             # the mean head and the marginal std's einsum
    det = trunk + head
    q = list(zip([obs + act, *h], [*h, 1]))
    collect = _macs(trunk + head + head)     # mean + phi @ (sigma * E)
    # the soft target (no gradient); Q1, Q2 forward, weight and input gradients
    critic_update = _macs(sample) + 2 * _macs(q) + 2 * (2 * _macs(q) + _macs(q, skip_first=True))
    # the sample and two deterministic passes under the updated critic, whose
    # gradient flows back to the action through every product
    actor_update = (_macs(sample) + 2 * _macs(det) + 2 * _macs(q) + 2 * _macs(q)
                    + _macs(sample) + _macs(sample, skip_first=True)
                    + 2 * (_macs(det) + _macs(det, skip_first=True)))
    rows = L["batch_size"] * L["update_fusion"]
    updates = L["gradient_steps"] // L["update_fusion"]
    macs = (collect * L["num_envs"] * L["train_freq"]
            + (critic_update + actor_update) * rows * updates)
    return 2.0 * macs

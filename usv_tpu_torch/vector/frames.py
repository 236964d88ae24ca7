"""Rolling frame-stack primitives — port of ``usv_tpu/vector/frames.py``.

The newest observation enters at the end of the stack dimension, and on
episode end (done) the whole stack refills with the new episode's first
observation: VecFrameStack-after-reset semantics.

Shapes: frames ``(..., S, D)``, obs ``(..., D)``, done ``(...,)`` bool.
"""

from __future__ import annotations

import torch


def init_frames(obs, stack: int):
    """Tile ``obs (..., D)`` into a full stack ``(..., max(1, stack), D)``
    (a broadcast view: states are values and are never written into)."""
    return obs.unsqueeze(-2).expand(*obs.shape[:-1], max(1, stack), obs.shape[-1])


def push_frames(frames, obs, done):
    """Shift ``obs`` into ``frames``; refill the stack where ``done``."""
    new = torch.cat([frames[..., 1:, :], obs.unsqueeze(-2)], dim=-2)
    refill = init_frames(obs, frames.shape[-2])
    return torch.where(done[..., None, None], refill, new)

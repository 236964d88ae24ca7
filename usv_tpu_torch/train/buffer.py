"""Device-resident replay buffer — port of ``usv_tpu/train/buffer.py``.

The buffer is five tensors preallocated once on the learner's device and
written in place: an insert is an aligned slice copy (learner path) or a
wrap-around scatter (general path), a sample an indexed gather, so no
transition crosses to the host. ``ptr`` and ``size`` are host integers: every
insert has a row count the host knows, so the learner's warm-up gate on the
fill reads no device value.

A seed population's buffer (:func:`buffer_init_many`) is the same five
tensors with a leading member axis ``(S, cap, ...)``: every member writes its
own rows at the one shared write head, and :func:`buffer_sample_many` gathers
each member's own indices in one indexed read per field.

The shard-local variants of the JAX module (``buffer_add_traj_local``,
``buffer_sample_local``, ``buffer_reshard_local``) belong to the data-parallel
layer and wait for it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ReplayBuffer:
    obs: torch.Tensor        # (cap, obs_dim), or (S, cap, obs_dim) for a population
    action: torch.Tensor     # (cap, act_dim)
    reward: torch.Tensor     # (cap,)
    next_obs: torch.Tensor   # (cap, obs_dim)
    done: torch.Tensor       # (cap,)  1.0 where terminated (not truncated)
    ptr: int = 0             # next write position
    size: int = 0            # current fill

    FIELDS = ("obs", "action", "reward", "next_obs", "done")

    @property
    def capacity(self) -> int:
        return self.obs.shape[-2]

    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in self.FIELDS)


def buffer_init(capacity: int, obs_dim: int, act_dim: int, dtype=torch.float32,
                device="cpu") -> ReplayBuffer:
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplayBuffer(obs=zeros(capacity, obs_dim), action=zeros(capacity, act_dim),
                        reward=zeros(capacity), next_obs=zeros(capacity, obs_dim),
                        done=zeros(capacity))


def buffer_add_batch(buf: ReplayBuffer, obs, action, reward, next_obs, done,
                     aligned: bool = False) -> ReplayBuffer:
    """Insert B transitions at the write head (wrap-around), in place.

    ``aligned=True`` is the fast path for callers that guarantee EVERY write
    to this buffer has the same row count B with ``capacity % B == 0`` (the
    write head then stays B-aligned and never wraps mid-batch): the insert is
    one slice copy per field instead of a scatter. The learners round their
    capacity up to guarantee the invariant. The default scatter path is
    correct for any write sequence. Returns ``buf``.
    """
    cap = buf.capacity
    b = obs.shape[0]
    if b > cap:
        raise ValueError(
            f"batch of {b} transitions exceeds buffer capacity {cap}; "
            "modulo indices would silently collide"
        )
    if aligned and cap % b:
        raise ValueError(f"aligned insert needs capacity ({cap}) % rows ({b}) == 0")
    rows = dict(obs=obs, action=action, reward=reward, next_obs=next_obs, done=done)
    if aligned:
        for name, value in rows.items():
            getattr(buf, name)[buf.ptr:buf.ptr + b].copy_(value)
    else:
        idx = (buf.ptr + torch.arange(b, device=buf.obs.device)) % cap
        for name, value in rows.items():
            dst = getattr(buf, name)
            dst.index_copy_(0, idx, value.to(dst.dtype))
    buf.ptr = (buf.ptr + b) % cap
    buf.size = min(buf.size + b, cap)
    return buf


def buffer_sample(buf: ReplayBuffer, batch_size: int,
                  generator: Optional[torch.Generator] = None,
                  idx: Optional[torch.Tensor] = None) -> dict:
    """``batch_size`` rows drawn uniformly from the filled part, as a dict of
    gathered tensors. ``idx`` (a test feeds JAX's ``randint`` draw) replaces
    the draw from ``generator``."""
    if idx is None:
        idx = torch.randint(0, max(buf.size, 1), (batch_size,), generator=generator,
                            device=buf.obs.device)
    return {name: getattr(buf, name).index_select(0, idx) for name in ReplayBuffer.FIELDS}


def buffer_init_many(members: int, capacity: int, obs_dim: int, act_dim: int,
                     dtype=torch.float32, device="cpu") -> ReplayBuffer:
    """One buffer of ``capacity`` rows for each of ``members`` learners, as
    tensors with a leading member axis."""
    def zeros(*shape):
        return torch.zeros((members, *shape), dtype=dtype, device=device)

    return ReplayBuffer(obs=zeros(capacity, obs_dim), action=zeros(capacity, act_dim),
                        reward=zeros(capacity), next_obs=zeros(capacity, obs_dim),
                        done=zeros(capacity))


def buffer_add_many(buf: ReplayBuffer, obs, action, reward, next_obs, done) -> ReplayBuffer:
    """Every member's ``b`` new rows (tensors ``(S, b, ...)``) at the shared
    write head, in place: the aligned slice path of :func:`buffer_add_batch`
    (the population learner keeps ``capacity % b == 0``). Returns ``buf``."""
    cap = buf.capacity
    b = obs.shape[1]
    if cap % b:
        raise ValueError(f"aligned insert needs capacity ({cap}) % rows ({b}) == 0")
    for name, value in dict(obs=obs, action=action, reward=reward, next_obs=next_obs,
                            done=done).items():
        getattr(buf, name)[:, buf.ptr:buf.ptr + b].copy_(value)
    buf.ptr = (buf.ptr + b) % cap
    buf.size = min(buf.size + b, cap)
    return buf


def buffer_sample_many(buf: ReplayBuffer, idx: torch.Tensor) -> dict:
    """Member ``i``'s rows ``idx[i]`` (``idx`` is ``(S, batch)``), gathered
    for all members at once: a dict of ``(S, batch, ...)`` tensors."""
    members = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {name: getattr(buf, name)[members, idx] for name in ReplayBuffer.FIELDS}

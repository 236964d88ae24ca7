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

Under the data-parallel layer (``usv_tpu_torch/parallel``) the capacity axis
is sharded: with shard-local replay (:func:`buffer_add_traj_local`,
:func:`buffer_sample_local`) it is ``n`` contiguous blocks, one a shard, and
``ptr``/``size`` count a block's LOCAL rows (the same in every block: all envs
step in lockstep). Rank ``k`` of a process group holds block ``k`` alone; a
logical mesh holds all ``n`` in one tensor and works block by block.
:func:`buffer_reshard_local` re-lays such a buffer's content over another
shard count (a checkpoint restored on another topology).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from usv_tpu_torch.train.common import derived_seed, new_generator


@dataclasses.dataclass
class ReplayBuffer:
    obs: torch.Tensor        # (cap, obs_dim), or (S, cap, obs_dim) for a population
    action: torch.Tensor     # (cap, act_dim)
    reward: torch.Tensor     # (cap,)
    next_obs: torch.Tensor   # (cap, obs_dim)
    done: torch.Tensor       # (cap,)  1.0 where terminated (not truncated)
    ptr: int = 0             # next write position
    size: int = 0            # current fill
    # the global capacity axis is ``blocks`` contiguous blocks, each with this
    # ptr and size: n under shard-local replay on an n-shard mesh, else 1.
    # A rank's buffer is one of them and keeps the global count.
    blocks: int = 1

    FIELDS = ("obs", "action", "reward", "next_obs", "done")

    @property
    def capacity(self) -> int:
        return self.obs.shape[-2]

    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in self.FIELDS)


def buffer_init(capacity: int, obs_dim: int, act_dim: int, dtype=torch.float32,
                device="cpu", blocks: int = 1) -> ReplayBuffer:
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplayBuffer(obs=zeros(capacity, obs_dim), action=zeros(capacity, act_dim),
                        reward=zeros(capacity), next_obs=zeros(capacity, obs_dim),
                        done=zeros(capacity), blocks=blocks)


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


# --------------------------------------------------------------------------
# Shard-local variants (the data-parallel layer). Each shard appends its OWN
# envs' transitions to its OWN capacity block and samples batch_size/n rows
# of it; because the blocks fill equally, the union batch is a stratified
# uniform sample of the whole buffer. The replay then moves no rows between
# ranks: the gradient sums are the only steady-state collectives. A buffer
# written in local mode is not interchangeable with global mode (ptr/size
# count a block's rows).
# --------------------------------------------------------------------------


def _global_sizes(buf: ReplayBuffer, width: int, mesh):
    """(global capacity, global env width) of a buffer and a batch that may
    be one rank's share."""
    n_here = 1 if mesh.logical else mesh.size
    return buf.capacity * n_here, width * n_here


def buffer_add_traj_local(buf: ReplayBuffer, traj: dict, mesh) -> ReplayBuffer:
    """Shard-local insert of a ``(T, B, ...)`` trajectory dict, in place.

    Each shard flattens its ``(T, B/n, ...)`` rows step-major and writes
    them at its block's write head (an aligned slice copy: the block's
    capacity must be a multiple of the shard's ``T*B/n`` rows, which holds
    when capacity % (T*B) == 0). On a rank, ``traj`` and ``buf`` are the
    rank's share. Returns ``buf``."""
    n = mesh.size
    t, width = traj["obs"].shape[:2]
    cap, b = _global_sizes(buf, width, mesh)
    if b % n or cap % n:
        raise ValueError(f"num_envs ({b}) and capacity ({cap}) must divide "
                         f"the mesh axis ({n})")
    local_cap, local_b = cap // n, b // n
    if local_cap % (t * local_b):
        raise ValueError("local capacity must be a multiple of the local "
                         "write block for aligned inserts")
    if buf.blocks != n:
        if buf.size:
            raise ValueError(f"a buffer of {buf.blocks} block(s) holding rows takes no "
                             f"shard-local insert on {n} shards; see buffer_reshard_local")
        buf.blocks = n
    rows = t * local_b
    for j, s in enumerate(mesh.shards):
        lo = (s if mesh.logical else 0) * local_b
        start = j * local_cap + buf.ptr
        for name in ReplayBuffer.FIELDS:
            src = traj[name][:, lo:lo + local_b]
            getattr(buf, name)[start:start + rows].copy_(src.reshape(rows, *src.shape[2:]))
    buf.ptr = (buf.ptr + rows) % local_cap
    buf.size = min(buf.size + rows, local_cap)
    return buf


def buffer_sample_local(buf: ReplayBuffer, batch_size: int, mesh, seed: int = 0,
                        idx: Optional[torch.Tensor] = None) -> dict:
    """Stratified shard-local sample: ``batch_size/n`` rows of each shard's
    block, drawn uniformly from its fill by a generator seeded
    ``derived_seed(seed, shard)`` (the counterpart of JAX's
    ``fold_in(key, shard)``). ``idx`` (``(n, batch_size/n)`` block-local
    indices, e.g. JAX's draws) replaces the draws. Returns this process's
    rows of the batch, shard-major (all of them on a logical mesh)."""
    n = mesh.size
    if batch_size % n:
        raise ValueError(f"batch_size ({batch_size}) must divide the mesh "
                         f"axis ({n})")
    local_bs = batch_size // n
    local_cap = buf.capacity // len(mesh.shards)
    device = buf.obs.device
    rows = []
    for j, s in enumerate(mesh.shards):
        if idx is None:
            g = new_generator(derived_seed(seed, s), device)
            ix = torch.randint(0, max(buf.size, 1), (local_bs,), generator=g, device=device)
        else:
            ix = idx[s].to(device)
        rows.append(ix + j * local_cap)
    rows = torch.cat(rows)
    return {name: getattr(buf, name).index_select(0, rows) for name in ReplayBuffer.FIELDS}


def buffer_reshard_local(buf: ReplayBuffer, n_src: int, n_dst: int,
                         insert_rows: Optional[int] = None) -> ReplayBuffer:
    """Re-lay a SHARD-LOCAL buffer's content (the whole buffer, as one
    process holds it after a restore) from ``n_src`` to ``n_dst`` blocks:
    each source block's valid rows oldest first, concatenated shard-major,
    dealt into ``n_dst`` equal blocks. Capacity and the row multiset are
    kept; only which shard samples which row changes.

    Raises ``ValueError`` when the re-layout is not defined: a capacity that
    does not divide either count, or a total row count that does not divide
    the destination shards. ``insert_rows`` (the destination's per-shard
    write block, ``train_freq * num_envs // n_dst`` for SAC) makes it refuse
    a write head that the aligned insert could not continue from."""
    cap = buf.capacity
    if n_src < 1 or n_dst < 1 or cap % n_src or cap % n_dst:
        raise ValueError(
            f"capacity {cap} must divide both shard counts "
            f"(src {n_src}, dst {n_dst})"
        )
    if n_src == n_dst:
        return buf
    local_src, local_dst = cap // n_src, cap // n_dst
    size, ptr = buf.size, buf.ptr
    total = n_src * size
    if total % n_dst:
        raise ValueError(
            f"cannot reshard: {n_src} shards x {size} local rows = {total} "
            f"total rows does not divide {n_dst} destination shards; train "
            f"for a whole number of insert blocks first"
        )
    size_dst = total // n_dst
    if insert_rows is not None:
        if local_dst % insert_rows or size_dst % insert_rows:
            raise ValueError(
                f"resharded write head {size_dst} (local capacity "
                f"{local_dst}) is not aligned to the destination "
                f"insert block of {insert_rows} rows; continuing would "
                f"corrupt wrapping inserts — adjust num_envs/train_freq "
                f"or the shard count so the block divides both"
            )

    def re(x):
        blocks = x.reshape(n_src, local_src, *x.shape[1:])
        if size == local_src and ptr != 0:
            blocks = torch.roll(blocks, -ptr, dims=1)  # a full ring: the oldest row sits at ptr
        rows = blocks[:, :size].reshape(total, *x.shape[1:])
        out = torch.zeros((n_dst, local_dst, *x.shape[1:]), dtype=x.dtype, device=x.device)
        out[:, :size_dst] = rows.reshape(n_dst, size_dst, *x.shape[1:])
        return out.reshape(x.shape)

    return ReplayBuffer(**{name: re(getattr(buf, name)) for name in ReplayBuffer.FIELDS},
                        ptr=size_dst % local_dst, size=size_dst, blocks=n_dst)

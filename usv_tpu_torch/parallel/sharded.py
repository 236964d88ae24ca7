"""Sharding layouts for learner train states — port of
``usv_tpu/parallel/sharded.py``.

:func:`shard_sac_train_state` and :func:`shard_ppo_train_state` take a train
state as ``learner.init`` makes it (the whole env batch, the whole replay)
and keep what this rank holds: its rows of the env state, the frame stack and
the gSDE matrices, and its part of the replay; they broadcast the replicated
parts (networks, optimizer state, temperature, generator, counters) from
rank 0 and attach the mesh. The learners read the mesh from the state, so a
sharded state trains through the same ``train_rounds``/``train_iteration``
calls as an unsharded one, as a JAX array carries its sharding.

The replay's part is one of two layouts:

* shard-local replay (``buffer.blocks == n``): capacity block ``k``;
* global replay (``blocks == 1``), written in aligned step-major inserts of
  ``train_freq x B`` rows: global row ``g`` is step-row ``g // B``, env
  ``g % B``, so rank ``k`` keeps env columns ``[k*B/n, (k+1)*B/n)`` of every
  step-row, which are the rows its own envs write. No row moves on insert.

:func:`gather_buffer` carries a sharded buffer to the global layout (the
checkpoint's file holds it); :func:`shard_buffer` takes a rank's part of it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from usv_tpu_torch.parallel.mesh import EnvMesh, replicate, shard_env_batch
from usv_tpu_torch.train.buffer import ReplayBuffer


def _local_rows(x: torch.Tensor, mesh: EnvMesh, blocks: int, env_width: int) -> torch.Tensor:
    """This rank's part of a global-layout replay tensor (see the module
    docstring), or of the filled rows of one."""
    n = mesh.size
    if blocks == n:
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])[mesh.rank]
    if blocks != 1:
        raise ValueError(f"a replay of {blocks} shard blocks on a mesh of {n}: re-lay it "
                         "first (buffer_reshard_local)")
    lo, hi = mesh.bounds(env_width)
    steps = x.reshape(x.shape[0] // env_width, env_width, *x.shape[1:])
    return steps[:, lo:hi].reshape(-1, *x.shape[1:])


def shard_buffer(buf: ReplayBuffer, mesh: EnvMesh, env_width: int) -> ReplayBuffer:
    """This rank's part of a global-layout buffer (a logical mesh keeps it all)."""
    if mesh.logical:
        return buf
    n = mesh.size
    local_counts = buf.blocks == n or n == 1
    if not local_counts and (buf.ptr % n or buf.size % n):
        raise ValueError(f"write head {buf.ptr} / fill {buf.size} do not divide {n} ranks")
    return ReplayBuffer(
        **{f: _local_rows(getattr(buf, f), mesh, buf.blocks, env_width).clone()
           for f in ReplayBuffer.FIELDS},
        ptr=buf.ptr if local_counts else buf.ptr // n,
        size=buf.size if local_counts else buf.size // n,
        blocks=buf.blocks)


def filled_rows(buf: ReplayBuffer, blocks: int = 0) -> dict:
    """The rows a buffer holds: each of its ``blocks`` blocks' first ``size``
    (by default ``buf.blocks``, the whole buffer's; a rank holds one)."""
    blocks = blocks or buf.blocks

    def rows(x):
        return x.reshape(blocks, x.shape[0] // blocks, *x.shape[1:])[:, :buf.size] \
            .reshape(-1, *x.shape[1:])

    return {f: rows(getattr(buf, f)) for f in ReplayBuffer.FIELDS}


def gather_buffer(buf: ReplayBuffer, mesh: Optional[EnvMesh] = None, env_width: int = 0) -> dict:
    """The global layout's filled rows and counters, ``{field: rows, ptr,
    size, blocks}``, of a whole buffer (no mesh, or a logical one) or, on
    every rank, of the ranks' buffers (``env_width``: the global batch)."""
    if mesh is None or mesh.logical:
        return dict(filled_rows(buf), ptr=buf.ptr, size=buf.size, blocks=buf.blocks)
    n = mesh.size
    local = filled_rows(buf, 1)
    if buf.blocks == n:  # shard-local: block k's rows at slot k
        rows = mesh.assemble(list(local.values()))
        return dict(zip(local, rows), ptr=buf.ptr, size=buf.size, blocks=n)
    width = env_width // n  # global: this rank's env columns of every step-row
    cols = [x.reshape(x.shape[0] // width, width, *x.shape[1:]).transpose(0, 1).contiguous()
            for x in local.values()]
    rows = [x.transpose(0, 1).reshape(-1, *x.shape[2:]) for x in mesh.assemble(cols)]
    ptr, size = (buf.ptr, buf.size) if n == 1 else (buf.ptr * n, buf.size * n)
    return dict(zip(local, rows), ptr=ptr, size=size, blocks=1)


def _replicated(ts, fields) -> list:
    """The tensors of the replicated fields: module parameters and buffers,
    optimizer moments, ``log_alpha``, the generator's state and the counters."""
    out = []
    for name in fields:
        value = getattr(ts, name)
        if isinstance(value, torch.nn.Module):
            out += list(value.state_dict().values())
        elif isinstance(value, torch.optim.Optimizer):
            out += [v for state in value.state.values() for v in state.values()
                    if isinstance(v, torch.Tensor)]
        elif isinstance(value, torch.Tensor):
            out.append(value.detach())
    return out


def _replicate_state(ts, mesh: EnvMesh, fields, counters) -> None:
    """Rank 0's replicated values on every rank, in place."""
    if mesh.logical:
        return
    tensors = _replicated(ts, fields)
    gen = ts.generator.get_state()
    words = torch.tensor([getattr(ts, c) for c in counters], dtype=torch.int64)
    replicate(tensors + [gen, words], mesh)
    ts.generator.set_state(gen)
    for c, v in zip(counters, words.tolist()):
        setattr(ts, c, v)


def _check_unsharded(ts) -> None:
    if ts.mesh is not None:
        raise ValueError(f"the state is sharded already ({ts.mesh})")


def shard_sac_train_state(ts, mesh: EnvMesh):
    """``ts`` laid over ``mesh``: see the module docstring."""
    _check_unsharded(ts)
    width = ts.batch.frames.shape[0]
    _replicate_state(ts, mesh, ("actor", "critic", "target_critic", "actor_opt", "critic_opt",
                                "alpha_opt", "log_alpha"), ("env_steps", "grad_steps", "seed"))
    return dataclasses.replace(
        ts, batch=shard_env_batch(ts.batch, mesh), sde=shard_env_batch(ts.sde, mesh),
        buffer=shard_buffer(ts.buffer, mesh, width), mesh=mesh)


def shard_ppo_train_state(ts, mesh: EnvMesh):
    """``ts`` laid over ``mesh``: its env rows and gSDE matrices kept, the
    rest replicated from rank 0."""
    _check_unsharded(ts)
    _replicate_state(ts, mesh, ("model", "opt"), ("update_count", "opt_steps", "seed"))
    return dataclasses.replace(ts, batch=shard_env_batch(ts.batch, mesh),
                               sde=shard_env_batch(ts.sde, mesh), mesh=mesh)

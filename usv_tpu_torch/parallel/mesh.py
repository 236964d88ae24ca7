"""The env mesh: which rows of the env batch a process holds, and the few
collectives the data-parallel layer uses — port of ``usv_tpu/parallel/mesh.py``.

JAX lays one SPMD program over a 1-D ``env`` mesh of devices: the env batch,
the frames, the gSDE matrices and the replay's capacity axis are sharded on
axis 0, everything else is replicated, and XLA inserts the collectives.
Here a mesh of ``n`` shards is one of two things:

* a process-group mesh (:func:`make_env_mesh` after
  :func:`~usv_tpu_torch.parallel.dist.initialize_distributed`): one process
  per rank, rank ``k`` holding rows ``[k*B/n, (k+1)*B/n)`` of every
  batch-first tensor and capacity block ``k`` of a shard-local replay, the
  learner replicated on every rank. The only collectives are explicit:
  :meth:`EnvMesh.all_sum`, :meth:`EnvMesh.broadcast` and
  :meth:`EnvMesh.assemble`, built on ``all_reduce`` and ``broadcast`` alone,
  the two collectives that gloo carries for CUDA tensors too;
* a logical mesh (``make_env_mesh(n_shards=n)`` with no process group): one
  process holding all ``n`` shards, as JAX's virtual CPU devices do. The
  shard-local functions then act on all ``n`` blocks of one tensor, and
  :func:`per_shard` runs a row-wise network call block by block at the
  width a rank runs it, so that a logical run and a run on ranks compute the
  same rows bit for bit. Its collectives are identities.

Every collective adds its calls and bytes to :attr:`EnvMesh.traffic`.

JAX's ``batch_sharding``/``replicated_sharding`` return ``NamedSharding``
layout tags that XLA reads; nothing here reads a tag, so they have no
counterpart: :func:`shard_env_batch` and :func:`replicate` do the placing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from usv_tpu_torch.envs.types import tree_leaves, tree_map


@dataclasses.dataclass
class Traffic:
    """What the mesh's collectives moved since the last :meth:`reset`."""
    calls: int = 0
    bytes: int = 0

    def reset(self) -> None:
        self.calls, self.bytes = 0, 0


class EnvMesh:
    """A 1-D ``env`` mesh of ``size`` shards; see the module docstring."""

    def __init__(self, size: int, rank: int = 0, device=None, group=None):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a mesh of {size}")
        self.size = size
        self.rank = rank
        self.device = None if device is None else torch.device(device)
        self.group = group
        self.backend = None if group is None else dist.get_backend(group)
        self.traffic = Traffic()

    def __repr__(self):
        kind = "logical" if self.logical else f"rank {self.rank}, {self.backend}"
        return f"EnvMesh(size={self.size}, {kind}, device={self.device})"

    @property
    def logical(self) -> bool:
        """One process holds every shard (no process group)."""
        return self.group is None

    @property
    def shards(self) -> range:
        """The shard indices this process holds."""
        return range(self.size) if self.logical else range(self.rank, self.rank + 1)

    def bounds(self, total: int):
        """``(lo, hi)``: the rows of a global axis of ``total`` this process holds."""
        if total % self.size:
            raise ValueError(f"{total} rows do not divide the mesh's {self.size} shards")
        if self.logical:
            return 0, total
        per = total // self.size
        return self.rank * per, (self.rank + 1) * per

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a global-width tensor (a view)."""
        lo, hi = self.bounds(x.shape[0])
        return x if self.logical else x[lo:hi]

    # ------------------------------------------------------------ collectives

    def _run(self, flat: torch.Tensor, collective) -> None:
        collective(flat)
        self.traffic.calls += 1
        self.traffic.bytes += flat.numel() * flat.element_size()

    def _flat_call(self, tensors: Sequence[torch.Tensor], collective) -> List[torch.Tensor]:
        """One collective per dtype over the tensors flattened into one buffer
        on the mesh's device; returns the results in the tensors' shapes,
        devices and dtypes (bool travels as int32)."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            wire = torch.int32 if dtype == torch.bool else dtype
            flat = torch.cat([tensors[i].reshape(-1).to(self.device, wire) for i in idx])
            self._run(flat, collective)
            offset = 0
            for i in idx:
                t = tensors[i]
                out[i] = flat[offset:offset + t.numel()].view(t.shape).to(t.device, dtype)
                offset += t.numel()
        return out

    def all_sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every tensor summed over the ranks (one ``all_reduce`` per dtype);
        a logical mesh returns them as they are."""
        tensors = list(tensors)
        if self.logical:
            return tensors
        return self._flat_call(tensors, lambda flat: dist.all_reduce(flat, group=self.group))

    def broadcast(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite every tensor, in place, with rank ``src``'s."""
        tensors = list(tensors)
        if self.logical or not tensors:
            return
        got = self._flat_call(tensors, lambda flat: dist.broadcast(flat, src, group=self.group))
        with torch.no_grad():
            for t, g in zip(tensors, got):
                t.copy_(g)

    def assemble(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's rows put back together: the full-width tensor, zero
        outside this rank's rows, summed over the ranks. Every rank gets the
        whole; a logical mesh already holds it."""
        tensors = list(tensors)
        if self.logical:
            return tensors
        padded = []
        for t in tensors:
            full = torch.zeros((t.shape[0] * self.size, *t.shape[1:]), dtype=t.dtype, device=t.device)
            full[self.rank * t.shape[0]:(self.rank + 1) * t.shape[0]] = t
            padded.append(full)
        return self.all_sum(padded)


def make_env_mesh(n_shards: Optional[int] = None, device=None) -> EnvMesh:
    """The mesh of the process group when one is up (its size the world
    size); else a logical mesh of ``n_shards`` (default 1) in this process."""
    if dist.is_initialized():
        from usv_tpu_torch.parallel.dist import rank_device

        world = dist.get_world_size()
        if n_shards is not None and n_shards != world:
            raise ValueError(f"n_shards={n_shards} in a process group of {world} ranks")
        return EnvMesh(world, dist.get_rank(), device or rank_device(), group=dist.group.WORLD)
    return EnvMesh(1 if n_shards is None else n_shards, 0, device)


def shard_env_batch(tree, mesh: EnvMesh):
    """This process's rows of a batch-first dataclass (or dict) of tensors."""
    if isinstance(tree, dict):
        return {k: shard_env_batch(v, mesh) for k, v in tree.items()}
    return tree_map(lambda x: mesh.local(x).clone(), tree)


def unshard_env_batch(tree, mesh: EnvMesh):
    """The inverse of :func:`shard_env_batch` on every rank: the full batch."""
    if isinstance(tree, dict):
        return {k: unshard_env_batch(v, mesh) for k, v in tree.items()}
    if tree is None or mesh.logical:
        return tree
    leaves = iter(mesh.assemble(tree_leaves(tree)))
    return tree_map(lambda _: next(leaves), tree)


def replicate(tree, mesh: EnvMesh):
    """Rank 0's values of every tensor leaf (params, optimizer state) of a
    state or a list of states on every rank, in place; returns ``tree``."""
    trees = tree if isinstance(tree, (list, tuple)) else [tree]
    mesh.broadcast([leaf for t in trees for leaf in tree_leaves(t)])
    return tree


def per_shard(mesh: Optional[EnvMesh], fn, *trees):
    """``fn(*trees)`` for a row-wise function, called once per shard on that
    shard's rows when one process holds several shards (a logical mesh), and
    the outputs (a tensor or a tuple of tensors) concatenated: the calls a
    rank makes, at the widths it makes them."""
    if mesh is None or not mesh.logical or mesh.size == 1:
        return fn(*trees)
    outs = []
    for s in range(mesh.size):
        def rows(x, s=s):
            per = x.shape[0] // mesh.size
            return x[s * per:(s + 1) * per]

        outs.append(fn(*(tree_map(rows, t) for t in trees)))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)

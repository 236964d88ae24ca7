"""Process groups and per-rank seeds — port of ``usv_tpu/parallel/dist.py``.

JAX brings a multi-host run up with ``jax.distributed.initialize`` and from
then on sees the chips of every host as one device list. Data parallelism
here is one process per rank: :func:`initialize_distributed` brings up the
``torch.distributed`` process group that the ranks share, and
:func:`~usv_tpu_torch.parallel.mesh.make_env_mesh` then builds the mesh of
the world.

Backends: ``nccl`` for a CUDA device, ``gloo`` for the CPU, unless the caller
names one. NCCL refuses two ranks on one GPU, so a caller that puts several
ranks on one card passes ``backend="gloo"`` itself (gloo carries the
``all_reduce`` and ``broadcast`` of CUDA tensors through the host). Nothing
here switches backend or device on its own.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from usv_tpu_torch.train.common import derived_seed

LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

_rank_device: Optional[torch.device] = None


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device() -> torch.device:
    """The device :func:`initialize_distributed` gave this rank."""
    if _rank_device is None:
        raise RuntimeError("no process group: call initialize_distributed() first")
    return _rank_device


def _resolve(device, local_rank: int, backend: Optional[str]) -> torch.device:
    """The rank's device: the card of its local rank unless the caller names
    one; raises without CUDA when the caller asked for nothing."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("usv_tpu_torch runs on a CUDA device by default and none is "
                               "available; pass device='cpu' to run the ranks on the CPU")
        count = torch.cuda.device_count()
        if local_rank >= count:
            raise ValueError(f"local rank {local_rank} has no card of its own ({count} visible); "
                             "pass device= and backend='gloo' to put several ranks on one card")
        return torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """Bring up the process group; returns whether this call did.

    An explicit ``num_processes <= 1`` is a no-op, as in JAX. A bare call
    reads a launcher's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` (torchrun sets them): without them it is a no-op, with
    them it brings the group up even at ``WORLD_SIZE=1``, so that one rank
    runs the collectives that more ranks run. Explicit arguments must form a
    cluster (all three, ``0 <= process_id < num_processes``) or it raises.

    ``device`` defaults to the card of the launcher's ``LOCAL_RANK`` (else of
    ``process_id``); under NCCL it becomes the current CUDA device.
    """
    global _rank_device
    if num_processes is not None and num_processes <= 1:
        return False
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        if not all(k in os.environ for k in LAUNCHER_VARS):
            return False  # no launcher: one process, nothing to bring up
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif any(v is None for v in given):
        raise ValueError("coordinator_address, num_processes and process_id form a cluster "
                         f"together; got {given}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside a cluster of {num_processes}")
    if dist.is_initialized():
        raise RuntimeError("a process group is already up in this process")
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    device = _resolve(device, local_rank, backend)
    backend = backend or default_backend(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _rank_device = device
    return True


def shutdown_distributed() -> None:
    """Destroy the process group, if one is up."""
    global _rank_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device = None


def fold_host_key(seed: int, process_index: Optional[int] = None) -> int:
    """A per-rank seed from ``seed`` (per-host env randomisation): the port's
    counterpart of ``jax.random.fold_in(key, process_index)``, through
    :func:`~usv_tpu_torch.train.common.derived_seed` (the port does not share
    JAX's key stream)."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    return derived_seed(seed, process_index)

"""Checkpointing of learner + env state — port of
``usv_tpu/train/checkpoint.py``, with ``torch.save`` in place of orbax.

A checkpoint holds everything a resumed run needs to continue bit for bit:
the modules' and optimizers' ``state_dict``s, ``log_alpha``, the env state
(nested dataclasses as nested dicts of named tensors), the frame stack, the
gSDE state, the replay buffer with ``ptr``/``size``, the counters and the
``get_state()`` of the training generator. It is one file,
``<path>/<step>/train_state.pt``, loaded with ``weights_only=True``.

A state sharded over a process group (``usv_tpu_torch/parallel``) is saved as
its global layout, the file an unsharded state of the same content gives:
every rank takes part in assembling the env rows and the replay, and rank 0
writes. A sharded run restores that file whole into an unsharded template
and then shards it (``shard_sac_train_state``), which keeps the rank's part.
The replay's ``blocks`` (the shard count of a shard-local replay) come from
the file, so that a replay saved on one topology can be re-laid with
``buffer_reshard_local`` before it is sharded over another.

A torch checkpoint is not an orbax one: policy bundles cross between the two
packages, checkpoints do not.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import torch

from usv_tpu_torch.parallel.mesh import unshard_env_batch
from usv_tpu_torch.parallel.sharded import gather_buffer
from usv_tpu_torch.train.buffer import ReplayBuffer

FILE = "train_state.pt"
_NOT_SAVED = ("mesh",)  # a train state's mesh belongs to the process, not to the run


def _pack(value):
    """A train-state value as what ``torch.load(weights_only=True)`` reads:
    tensors, dicts, lists and Python scalars."""
    if isinstance(value, (torch.nn.Module, torch.optim.Optimizer)):
        return value.state_dict()
    if isinstance(value, torch.Generator):
        return value.get_state()
    if isinstance(value, ReplayBuffer):
        return _pack_buffer(gather_buffer(value))
    if dataclasses.is_dataclass(value):
        return {f.name: _pack(getattr(value, f.name)) for f in dataclasses.fields(value)
                if f.name not in _NOT_SAVED}
    if value is None or isinstance(value, (torch.Tensor, bool, int, float, str)):
        return value
    raise TypeError(f"cannot checkpoint a {type(value).__name__}")


def _pack_buffer(rows: dict) -> dict:
    """A buffer's filled rows (rows past each block's fill are zeros and are
    not written) and counters, on the host."""
    return {k: v.to("cpu", copy=True) if isinstance(v, torch.Tensor) else v for k, v in rows.items()}


def _tensor_like(template: torch.Tensor, saved: torch.Tensor, name: str) -> torch.Tensor:
    if not isinstance(saved, torch.Tensor) or saved.shape != template.shape \
            or saved.dtype != template.dtype:
        got = tuple(saved.shape) if isinstance(saved, torch.Tensor) else type(saved).__name__
        raise ValueError(f"checkpoint entry {name!r}: {got} does not fit the template's "
                         f"{tuple(template.shape)} {template.dtype}")
    return saved.to(template.device)


def _unpack(template, saved, name="state"):
    """``saved`` loaded into ``template``'s objects: modules, optimizers,
    generators, the buffer and a mutable dataclass's tensors in place (an
    optimizer holds references to them); a frozen dataclass (an env state,
    the frame stack's ``BatchState``, the gSDE state) rebuilt with new
    tensors on the template's device. Returns the loaded value."""
    if isinstance(template, (torch.nn.Module, torch.optim.Optimizer)):
        template.load_state_dict(saved)
        return template
    if isinstance(template, torch.Generator):
        template.set_state(saved)
        return template
    if isinstance(template, ReplayBuffer):
        n, blocks = saved["size"], saved.get("blocks", 1)
        with torch.no_grad():
            for f in ReplayBuffer.FIELDS:
                dst = getattr(template, f)
                dst = dst.view(blocks, dst.shape[0] // blocks, *dst.shape[1:])
                dst[:, :n].copy_(_tensor_like(dst[:, :n], saved[f].view(blocks, n, *dst.shape[2:]),
                                              f"{name}.{f}"))
                dst[:, n:].zero_()
        template.ptr, template.size, template.blocks = saved["ptr"], n, blocks
        return template
    if dataclasses.is_dataclass(template):
        fields = [f.name for f in dataclasses.fields(template) if f.name not in _NOT_SAVED]
        if template.__dataclass_params__.frozen:
            return dataclasses.replace(template, **{
                f: _unpack(getattr(template, f), saved[f], f"{name}.{f}") for f in fields})
        for f in fields:
            value = getattr(template, f)
            if isinstance(value, torch.Tensor):
                with torch.no_grad():
                    value.copy_(_tensor_like(value, saved[f], f"{name}.{f}"))
            elif isinstance(value, ReplayBuffer) and saved[f] is None:
                pass  # a light checkpoint: the template's (empty) buffer stays
            else:
                setattr(template, f, _unpack(value, saved[f], f"{name}.{f}"))
        return template
    if isinstance(template, torch.Tensor):
        return _tensor_like(template, saved, name)
    if template is None and saved is not None:
        raise ValueError(f"checkpoint entry {name!r} holds a value the template lacks")
    return saved


def save_checkpoint(path, train_state, step: int, include_buffer: bool = True) -> str:
    """Save ``train_state`` under ``path/step``.

    ``include_buffer=False`` drops the replay buffer (by far the largest
    part: 2.6 GB at 1024 envs with frame_stack 5 and 400k rows); restoring
    such a "light" checkpoint keeps the template's buffer, so training
    resumes with a fresh, empty one. Written to a temporary file and
    renamed, so that an interrupted save leaves no partial checkpoint.

    Every rank of a sharded state calls it (the assembly is collective);
    rank 0 writes the file, and no rank returns before it is written.
    """
    mesh = getattr(train_state, "mesh", None)
    ranks = mesh is not None and not mesh.logical
    buffer = getattr(train_state, "buffer", None)
    if ranks:  # the global layout: assemble the env rows and the replay
        train_state = dataclasses.replace(
            train_state, batch=unshard_env_batch(train_state.batch, mesh),
            sde=unshard_env_batch(train_state.sde, mesh))
    if buffer is not None:
        train_state = dataclasses.replace(train_state, buffer=None)
    packed = _pack(train_state)
    if buffer is not None and include_buffer:
        packed["buffer"] = _pack_buffer(gather_buffer(buffer, mesh, train_state.batch.frames.shape[0]))
    out = Path(path).absolute() / str(int(step))
    if not ranks or mesh.rank == 0:
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / (FILE + ".tmp")
        torch.save({"step": int(step), "state": packed}, tmp)
        os.replace(tmp, out / FILE)
    if ranks:  # every rank returns once the file is on disk
        mesh.all_sum([torch.zeros(1, device=mesh.device)])
    return str(out / FILE)


def restore_checkpoint(path, template, step: int | None = None):
    """Restore into ``template`` (a train state of the same learner and
    config, e.g. a fresh ``learner.init()``; unsharded: shard the result),
    in place; returns ``(state, step)``. If ``step`` is None the latest step
    directory under ``path`` is used."""
    mesh = getattr(template, "mesh", None)
    if mesh is not None and not mesh.logical:
        raise ValueError(f"restore into an unsharded template, then shard it (got one on {mesh})")
    path = Path(path).absolute()
    if step is None:
        steps = sorted(int(p.name) for p in path.iterdir() if p.name.isdigit()) \
            if path.is_dir() else []
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    saved = torch.load(path / str(step) / FILE, map_location="cpu", weights_only=True)
    return _unpack(template, saved["state"]), saved["step"]

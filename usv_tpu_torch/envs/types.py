"""Common environment interfaces — port of ``usv_tpu/envs/types.py``.

Every environment is a pair of functions over batch-first tensor states

    reset(cfg, generator, num_envs, device) -> EnvState
    step(cfg, state, action)                -> (EnvState, TimeStep)

where every tensor of a state or a TimeStep has the env batch as its first
dimension. A state is a frozen dataclass whose fields are tensors or further
such dataclasses (``SimpleAsmcEnvState.base``, ``.ctrl``); :func:`tree_map`
walks them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class TimeStep:
    """One batched transition's outputs (the gymnasium 5-tuple minus the
    state); ``info`` is a flat dict of fixed-shape tensors."""

    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: Dict[str, Any]

    @property
    def done(self):
        return torch.logical_or(self.terminated, self.truncated)


def tree_map(fn, state, *others):
    """``fn`` applied to every tensor leaf of ``state`` (and to the matching
    leaves of ``others``), the results put back into the same dataclasses.
    Fields that are dataclasses are walked; ``None`` stays ``None``."""
    if state is None:
        return None
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: tree_map(fn, getattr(state, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(state)
        })
    return fn(state, *others)


def tree_leaves(state):
    """The tensor leaves of a (nested) state, in field order."""
    if state is None:
        return []
    if dataclasses.is_dataclass(state):
        return [leaf for f in dataclasses.fields(state)
                for leaf in tree_leaves(getattr(state, f.name))]
    return [state]


def reset_uniform(generator: torch.Generator, rows: int, width: int, device,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A reset's ``(rows, width)`` float32 block of U[0, 1) draws from
    ``generator``: ``uniform_`` into ``out`` (a static buffer of that shape)
    or into a new tensor. Every reset block of the port is drawn here, so a
    step that fills a buffer draws the bits, and leaves the generator in the
    state, of one that draws a new block (``torch.rand`` is ``empty`` then
    ``uniform_``)."""
    if out is None:
        out = torch.empty((rows, width), dtype=torch.float32, device=device)
    return out.uniform_(generator=generator)


def reset_from_generator(reset_from_uniform: Callable, n_uniform: Callable) -> Callable:
    """A family's ``reset(cfg, generator, num_envs, device)``: ``num_envs``
    fresh envs from one :func:`reset_uniform` block of ``(num_envs,
    n_uniform(cfg))`` drawn from ``generator`` and handed to
    ``reset_from_uniform``."""

    def reset(cfg, generator: torch.Generator, num_envs: int, device):
        return reset_from_uniform(cfg, reset_uniform(generator, num_envs, n_uniform(cfg), device))

    return reset

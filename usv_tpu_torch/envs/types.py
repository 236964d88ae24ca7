"""Common environment interfaces — port of ``usv_tpu/envs/types.py``.

Every environment is a pair of functions over batch-first tensor states

    reset(cfg, generator, num_envs, device) -> EnvState
    step(cfg, state, action)                -> (EnvState, TimeStep)

where every tensor of a state or a TimeStep has the env batch as its first
dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

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

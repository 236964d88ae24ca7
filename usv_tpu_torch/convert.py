"""Carrying state across from the JAX package.

The JAX side hands its pytrees over as numpy arrays (``np.asarray`` of each
leaf), so this module imports neither JAX nor ``usv_tpu``. Later slices add
the flax-params converters here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from usv_tpu_torch.envs.simple import SimpleEnvState

_DTYPES = {"obs_mask": torch.bool, "step_count": torch.int32}  # the rest: float32


def simple_state_from_numpy(leaves: Dict[str, np.ndarray], device) -> SimpleEnvState:
    """A vmapped JAX ``SimpleEnvState`` (field name -> (B, ...) numpy array)
    as the port's state on ``device``. The ``key`` leaf is ignored: the port
    draws from a ``torch.Generator`` instead."""
    fields = {}
    for f in dataclasses.fields(SimpleEnvState):
        dtype = _DTYPES.get(f.name, torch.float32)
        fields[f.name] = torch.tensor(np.asarray(leaves[f.name]), dtype=dtype, device=device)
    return SimpleEnvState(**fields)

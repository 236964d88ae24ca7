"""Carrying state across from the JAX package.

The JAX side hands its pytrees over as numpy arrays: a vmapped state becomes
a dict of field name -> ``(B, ...)`` array, a nested state (``base``,
``ctrl``, ``dyn``) a nested dict, and the ``key`` leaf is dropped (the port
draws from a ``torch.Generator`` instead). So this module imports neither JAX
nor ``usv_tpu``. Bool and int32 leaves keep their type; every float leaf
becomes float32. No weights exist in the slices ported so far; later slices
add the flax-params converters here.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Dict

import numpy as np
import torch

from usv_tpu_torch.control.aitsmc import AitsmcState
from usv_tpu_torch.control.asmc import AsmcState
from usv_tpu_torch.envs.asmc_ca import CaEnvState
from usv_tpu_torch.envs.simple import SimpleEnvState
from usv_tpu_torch.envs.simple_aitsmc import SimpleAitsmcEnvState
from usv_tpu_torch.envs.simple_asmc import SimpleAsmcEnvState
from usv_tpu_torch.physics.dynamics import DynamicsState


def state_from_numpy(cls, leaves: Dict[str, object], device):
    """The port's state ``cls`` on ``device`` from a (nested) dict of numpy
    arrays; entries that ``cls`` has no field for (``key``) are ignored."""
    hints = typing.get_type_hints(cls)
    fields = {}
    for f in dataclasses.fields(cls):
        value = leaves[f.name]
        if isinstance(value, dict):
            fields[f.name] = state_from_numpy(hints[f.name], value, device)
            continue
        array = np.asarray(value)
        if array.dtype == np.bool_:
            dtype = torch.bool
        elif np.issubdtype(array.dtype, np.integer):
            dtype = torch.int32
        else:
            dtype = torch.float32
        fields[f.name] = torch.tensor(array, dtype=dtype, device=device)
    return cls(**fields)


def _converter(cls):
    def convert(leaves: Dict[str, object], device):
        return state_from_numpy(cls, leaves, device)

    convert.__doc__ = (f"A vmapped JAX ``{cls.__name__}`` (field name -> (B, ...) numpy "
                       "array, nested states as nested dicts) as the port's state on ``device``.")
    return convert


dynamics_state_from_numpy = _converter(DynamicsState)
asmc_state_from_numpy = _converter(AsmcState)
aitsmc_state_from_numpy = _converter(AitsmcState)
simple_state_from_numpy = _converter(SimpleEnvState)
simple_asmc_state_from_numpy = _converter(SimpleAsmcEnvState)
simple_aitsmc_state_from_numpy = _converter(SimpleAitsmcEnvState)
ca_state_from_numpy = _converter(CaEnvState)

"""Carrying state and weights across from the JAX package.

The JAX side hands its pytrees over as numpy arrays: a vmapped state becomes
a dict of field name -> ``(B, ...)`` array, a nested state (``base``,
``ctrl``, ``dyn``, ``path``) a nested dict, and the ``key`` leaf is dropped
(the port draws from a ``torch.Generator`` instead). So this module imports
neither JAX nor ``usv_tpu``. Bool and int32 leaves keep their type; every
float leaf becomes float32.

Weights cross as the flat dict the JAX package's ``export_numpy_policy``
writes: '/'-joined flax paths -> numpy arrays
(:func:`state_dict_from_flax`, and :func:`state_dict_to_flax` for
the way back).
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
from usv_tpu_torch.envs.curved import CurvedEnvState
from usv_tpu_torch.envs.legacy import LegacyState
from usv_tpu_torch.envs.simple import SimpleEnvState
from usv_tpu_torch.envs.simple_aitsmc import SimpleAitsmcEnvState
from usv_tpu_torch.envs.simple_asmc import SimpleAsmcEnvState
from usv_tpu_torch.physics.dynamics import DynamicsState
from usv_tpu_torch.utils.path_gen import PchipPath


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
pchip_path_from_numpy = _converter(PchipPath)
curved_state_from_numpy = _converter(CurvedEnvState)
legacy_state_from_numpy = _converter(LegacyState)


# The flax name of the unnamed trunk of ``SquashedGaussianActor`` against the
# port's attribute; every other flax name is the port's own.
_FLAX_TRUNK, _TORCH_TRUNK = "MLP_0", "trunk"


def state_dict_from_flax(arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's module (``models/mlp.py``) from the
    parameters of its flax counterpart, as a dict of '/'-joined flax paths to
    numpy arrays: ``params/MLP_0/dense_0/kernel``, ``params/mean/bias``,
    ``params/log_std_sde``, ``params/pi_trunk/dense_1/kernel``,
    ``params/log_std``, ``params/q1/dense_2/bias`` and so on (an entry
    ``__meta__`` is ignored). A flax ``kernel`` is ``(in, out)`` and becomes
    the ``(out, in)`` ``weight`` of an ``nn.Linear``; a ``bias`` and a bare
    parameter keep their shape. Load the result with
    ``module.load_state_dict(..., strict=True)``: a missing or a surplus
    entry is an error there.
    """
    state = {}
    for path, array in arrays.items():
        if path == "__meta__":
            continue
        parts = path.split("/")
        if parts[0] != "params":
            raise ValueError(f"flax parameter path {path!r} does not start with 'params/'")
        parts = [_TORCH_TRUNK if p == _FLAX_TRUNK else p for p in parts[1:]]
        value = torch.tensor(np.asarray(array), dtype=torch.float32)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            value = value.t().contiguous()
        state[".".join(parts)] = value
    return state


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_dict_from_flax`: the flax layout that the
    numpy-only policy (``utils/numpy_policy.py``, and the JAX package's own)
    reads."""
    arrays = {}
    for name, value in state_dict.items():
        parts = [_FLAX_TRUNK if p == _TORCH_TRUNK else p for p in name.split(".")]
        value = value.detach().to("cpu", torch.float32)
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            value = value.t()
        arrays["/".join(["params"] + parts)] = np.ascontiguousarray(value.numpy())
    return arrays

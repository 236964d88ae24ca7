"""Environment registry — port of ``usv_tpu/envs/registry.py``.

``make(env_id, device=None, **overrides)`` returns an :class:`EnvHandle`
bound to a device: the CUDA card unless the caller names another one.
Only ``usv-simple`` is registered so far.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from usv_tpu_torch.envs import simple


class EnvHandle(NamedTuple):
    env_id: str
    cfg: Any
    device: torch.device
    reset: Callable               # (cfg, generator, num_envs, device) -> state
    reset_from_uniform: Callable  # (cfg, (B, n_uniform(cfg)) block) -> state
    n_uniform: Callable           # cfg -> width of one reset's uniform block
    step: Callable                # (cfg, state, action) -> (state, TimeStep)
    reset_obs: Callable           # (cfg, state) -> obs
    reset_info: Optional[Callable] = None  # (cfg, state) -> info dict


_REGISTRY = {
    "usv-simple": dict(
        config_cls=simple.SimpleEnvConfig,
        reset=simple.reset,
        reset_from_uniform=simple.reset_from_uniform,
        n_uniform=simple.n_uniform,
        step=simple.step,
        reset_obs=simple.reset_obs,
        reset_info=simple.reset_info,
    ),
}


def registered_ids():
    return sorted(_REGISTRY)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises if CUDA is asked for (or defaulted to) and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "usv_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


def make(env_id: str, device=None, **config_overrides) -> EnvHandle:
    if env_id not in _REGISTRY:
        raise KeyError(f"unknown env id {env_id!r}; registered: {registered_ids()}")
    entry = dict(_REGISTRY[env_id])
    cfg = entry.pop("config_cls")(**config_overrides)
    return EnvHandle(env_id=env_id, cfg=cfg, device=resolve_device(device), **entry)

"""Environment registry — port of ``usv_tpu/envs/registry.py``.

``make(env_id, device=None, **overrides)`` returns an :class:`EnvHandle`
bound to a device: the CUDA card unless the caller names another one. Each
entry bundles the config class and the batch-first pure functions of one env
family. Registered: every id of the JAX package — ``usv-simple``,
``usv-asmc-simple``, ``usv-aitsmc-simple``, ``usv-asmc-ca-v0``,
``usv-curved-aitsmc`` and the three legacy ids ``usv-asmc-v0``, ``usv-pid-v0``
and ``usv-asmc-ye-int-v0``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from usv_tpu_torch.envs import asmc_ca, curved, legacy, simple, simple_aitsmc, simple_asmc


class EnvHandle(NamedTuple):
    env_id: str
    cfg: Any
    device: torch.device
    reset: Callable               # (cfg, generator, num_envs, device) -> state
    reset_from_uniform: Callable  # (cfg, (B, n_uniform(cfg)) block) -> state
    n_uniform: Callable           # cfg -> width of one reset's uniform block
    step: Callable                # (cfg, state, action) -> (state, TimeStep)
    reset_obs: Callable           # (cfg, state) -> obs
    # (cfg, state) -> info dict of the post-reset state, for the families
    # whose reference reset returns one; None elsewhere
    reset_info: Optional[Callable] = None


def _entry(module, config_cls, reset_info=True):
    return dict(
        config_cls=config_cls,
        reset=module.reset,
        reset_from_uniform=module.reset_from_uniform,
        n_uniform=module.n_uniform,
        step=module.step,
        reset_obs=module.reset_obs,
        reset_info=module.reset_info if reset_info else None,
    )


def _legacy_entry(name, config_cls):
    """One of the three legacy ids: ``legacy.<function>_<name>``."""
    return dict(
        config_cls=config_cls,
        reset=getattr(legacy, f"reset_{name}"),
        reset_from_uniform=getattr(legacy, f"reset_from_uniform_{name}"),
        n_uniform=legacy.n_uniform,
        step=getattr(legacy, f"step_{name}"),
        reset_obs=getattr(legacy, f"reset_obs_{name}"),
        reset_info=None,
    )


_REGISTRY = {
    "usv-simple": _entry(simple, simple.SimpleEnvConfig),
    "usv-asmc-simple": _entry(simple_asmc, simple_asmc.SimpleAsmcEnvConfig),
    "usv-aitsmc-simple": _entry(simple_aitsmc, simple_aitsmc.SimpleAitsmcEnvConfig),
    "usv-asmc-ca-v0": _entry(asmc_ca, asmc_ca.CaEnvConfig, reset_info=False),
    "usv-curved-aitsmc": _entry(curved, curved.CurvedEnvConfig, reset_info=False),
    "usv-asmc-v0": _legacy_entry("asmc", legacy.LegacyAsmcConfig),
    "usv-pid-v0": _legacy_entry("pid", legacy.LegacyPidConfig),
    "usv-asmc-ye-int-v0": _legacy_entry("ye_int", legacy.LegacyYeIntConfig),
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

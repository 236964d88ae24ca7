"""Environment registry — port of ``usv_tpu/envs/registry.py``.

``make(env_id, device=None, **overrides)`` returns an :class:`EnvHandle`
bound to a device: the CUDA card unless the caller names another one. Each
entry bundles the config class and the batch-first pure functions of one env
family. :func:`register` adds a family (or replaces one); every id of the
JAX package goes through it — ``usv-simple``, ``usv-asmc-simple``,
``usv-aitsmc-simple``, ``usv-asmc-ca-v0``, ``usv-curved-aitsmc`` and the
three legacy ids ``usv-asmc-v0``, ``usv-pid-v0`` and ``usv-asmc-ye-int-v0``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from usv_tpu_torch.envs import asmc_ca, curved, legacy, simple, simple_aitsmc, simple_asmc
from usv_tpu_torch.envs.types import reset_from_generator


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


_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register(env_id: str, config_cls, reset_from_uniform: Callable, n_uniform: Callable,
             step: Callable, reset_obs: Callable, reset_info: Optional[Callable] = None):
    """Register an env family under ``env_id`` (an id registered before is
    replaced), so that :func:`make`, ``BatchedEnv``, ``rollout``,
    ``throughput`` and the learners take it.

    ``reset_from_uniform(cfg, u)`` builds ``B`` fresh states from a
    ``(B, n_uniform(cfg))`` block of uniforms in [0, 1); the entry's
    ``reset`` draws that block (``types.reset_from_generator``).
    ``step(cfg, state, action) -> (state, TimeStep)`` and
    ``reset_obs(cfg, state) -> obs`` are batch-first; ``reset_info(cfg,
    state)``, where given, is the post-reset info dict. The counterpart of
    ``usv_tpu.envs.registry.register``, whose ``reset(cfg, key)`` becomes
    the pair ``reset_from_uniform``, ``n_uniform``.
    """
    _REGISTRY[env_id] = dict(
        config_cls=config_cls,
        reset=reset_from_generator(reset_from_uniform, n_uniform),
        reset_from_uniform=reset_from_uniform,
        n_uniform=n_uniform,
        step=step,
        reset_obs=reset_obs,
        reset_info=reset_info,
    )


def _register_builtin():
    for env_id, module, config_cls, with_info in (
        ("usv-simple", simple, simple.SimpleEnvConfig, True),
        ("usv-asmc-simple", simple_asmc, simple_asmc.SimpleAsmcEnvConfig, True),
        ("usv-aitsmc-simple", simple_aitsmc, simple_aitsmc.SimpleAitsmcEnvConfig, True),
        ("usv-asmc-ca-v0", asmc_ca, asmc_ca.CaEnvConfig, False),
        ("usv-curved-aitsmc", curved, curved.CurvedEnvConfig, False),
    ):
        register(env_id, config_cls, module.reset_from_uniform, module.n_uniform, module.step,
                 module.reset_obs, reset_info=module.reset_info if with_info else None)
    # the three legacy ids: legacy.<function>_<name>
    for env_id, name, config_cls in (
        ("usv-asmc-v0", "asmc", legacy.LegacyAsmcConfig),
        ("usv-pid-v0", "pid", legacy.LegacyPidConfig),
        ("usv-asmc-ye-int-v0", "ye_int", legacy.LegacyYeIntConfig),
    ):
        register(env_id, config_cls, getattr(legacy, f"reset_from_uniform_{name}"),
                 legacy.n_uniform, getattr(legacy, f"step_{name}"),
                 getattr(legacy, f"reset_obs_{name}"))


_register_builtin()


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

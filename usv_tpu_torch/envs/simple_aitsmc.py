"""``usv-aitsmc-simple`` — the simple env with the AITSMC inner loop — port of
``usv_tpu/envs/simple_aitsmc.py``.

Per env step, 5 substeps of {AITSMC controller -> dynamic model with an
external perturbation}, then observation, reward and termination from the
base simple env with ``update_position=False``.

Semantics kept from the JAX module (reference ``simple_env_aitsmc.py``): the
0.8/0.2 setpoint filter on (u, r) against the previous setpoint (:49-61), the
setpoint constant across the substeps (:77-84), the model's own velocity kept
apart from the base reset's sampled one (:43), ``max_action`` forced to ones
(:103) and ``reference_velocity`` to 0.5 (:41) before the base step,
``last_action`` rewritten to the setpoint after it (:118), the controller's
debug values in info (:105-111), and the user perturbation as a pure function
of the env-step index (:31-35, 74-75) evaluated once per step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from usv_tpu_torch.control.aitsmc import (
    AitsmcGains,
    AitsmcLoopState,
    AitsmcSetpoint,
    AitsmcState,
    aitsmc_compute,
    init_aitsmc,
)
from usv_tpu_torch.envs import simple
from usv_tpu_torch.envs.simple import SimpleEnvConfig, SimpleEnvState
from usv_tpu_torch.envs.types import TimeStep, reset_from_generator
from usv_tpu_torch.physics.dynamics import DynamicsState
from usv_tpu_torch.physics.params import VehicleParams


def _zero_perturb(step):
    return torch.zeros(step.shape + (3,), dtype=torch.float32, device=step.device)


@dataclasses.dataclass(frozen=True)
class SimpleAitsmcEnvConfig(SimpleEnvConfig):
    max_episode_steps: int = 150   # gym_usv/__init__.py:36-40
    n_substeps: int = 5            # simple_env_aitsmc.py:77
    substep_dt: float = 0.01
    # Pure function of the (B,) int32 env-step index -> body-frame
    # (tau_x, tau_y, tau_z) as (B, 3); the 'perturb_func' reset option
    # (simple_env_aitsmc.py:31-35).
    perturb_fn: Callable = _zero_perturb


@dataclasses.dataclass(frozen=True)
class SimpleAitsmcEnvState:
    base: SimpleEnvState
    ctrl: AitsmcState
    accel_last: torch.Tensor    # (B, 3)
    eta_dot_last: torch.Tensor  # (B, 3)
    # the model's own velocity: the reference recreates its DynamicModel at
    # the drawn pose with ZERO velocity (simple_env_aitsmc.py:43); the base
    # reset's sampled velocity reaches only the reset obs, never the model
    model_vel: torch.Tensor     # (B, 3)
    perturb_step: torch.Tensor  # (B,) int32

    def replace(self, **changes) -> "SimpleAitsmcEnvState":
        return dataclasses.replace(self, **changes)


n_uniform = simple.n_uniform


def reset_from_uniform(cfg: SimpleAitsmcEnvConfig, u: torch.Tensor) -> SimpleAitsmcEnvState:
    """Base reset; fresh controller and model (reference :39-47).

    The reference sets ``reference_velocity = 0.5`` after the base reset has
    built the reset obs (:40-41), so the reset observation carries the
    sampled value and every later step uses 0.5: forced in :func:`step`."""
    base = simple.reset_from_uniform(cfg, u)
    z3 = torch.zeros_like(base.position)
    return SimpleAitsmcEnvState(
        base=base,
        ctrl=init_aitsmc((u.shape[0],), device=u.device),
        accel_last=z3,
        eta_dot_last=z3,
        model_vel=z3,
        perturb_step=torch.zeros_like(base.step_count),
    )


reset = reset_from_generator(reset_from_uniform, n_uniform)


def reset_obs(cfg: SimpleAitsmcEnvConfig, state: SimpleAitsmcEnvState):
    return simple.reset_obs(cfg, state.base)


def reset_info(cfg: SimpleAitsmcEnvConfig, state: SimpleAitsmcEnvState):
    """The base reset's info (simple_env_aitsmc.py:39-47 -> simple_env.py:303)."""
    return simple.reset_info(cfg, state.base)


def step(
    cfg: SimpleAitsmcEnvConfig,
    state: SimpleAitsmcEnvState,
    action,
    gains: AitsmcGains = AitsmcGains(),
    vparams: VehicleParams = VehicleParams(),
):
    """5 x {AITSMC -> model(+perturb)}, then the base step (reference :67-120).
    ``action`` is (B, 2) = (u, r) setpoints before the filter."""
    perturb = cfg.perturb_fn(state.perturb_step)

    # EMA setpoint against the previous setpoint-valued last_action (:58)
    last = state.base.last_action
    filt = 0.8 * torch.stack([last[:, 0], last[:, 2]], dim=-1) + 0.2 * action
    zeros = torch.zeros_like(filt[:, 0])
    setpoint = AitsmcSetpoint(u=filt[:, 0], r=filt[:, 1], dot_u=zeros, dot_r=zeros)

    loop = AitsmcLoopState(
        ctrl=state.ctrl,
        dyn=DynamicsState(
            pose=state.base.position,
            vel=state.model_vel,
            accel_last=state.accel_last,
            eta_dot_last=state.eta_dot_last,
        ),
    )
    loop, last_debug, _ = aitsmc_compute(
        gains, vparams, loop, setpoint, perturb,
        n_substeps=cfg.n_substeps, dt=cfg.substep_dt,
    )

    base = state.base.replace(
        position=loop.dyn.pose,
        velocity=loop.dyn.vel,
        max_action=torch.ones_like(state.base.max_action),  # ref :103
        # ref :41: every post-reset step runs with reference_velocity 0.5
        reference_velocity=torch.full_like(state.base.reference_velocity, 0.5),
    )
    base, ts = simple.step(cfg, base, action, update_position=False)

    # Rewrite last_action to the setpoint values (ref :118)
    base = base.replace(last_action=torch.stack([setpoint.u, zeros, setpoint.r], dim=-1))

    info = dict(ts.info)
    info.update(
        left_thruster=last_debug["tport"],
        right_thruster=last_debug["tstbd"],
        e_u=loop.ctrl.e_u,
        e_r=loop.ctrl.e_r,
        Ka_u=loop.ctrl.ka_u,
        Ka_r=loop.ctrl.ka_r,
        action0=action[:, 0],
        action1=action[:, 1],
        setpoint_u=setpoint.u,
        setpoint_r=setpoint.r,
        perturb=perturb,
    )

    new_state = SimpleAitsmcEnvState(
        base=base,
        ctrl=loop.ctrl,
        accel_last=loop.dyn.accel_last,
        eta_dot_last=loop.dyn.eta_dot_last,
        model_vel=loop.dyn.vel,
        perturb_step=state.perturb_step + 1,
    )
    return new_state, TimeStep(
        obs=ts.obs, reward=ts.reward,
        terminated=ts.terminated, truncated=ts.truncated, info=info,
    )

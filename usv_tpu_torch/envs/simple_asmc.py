"""``usv-asmc-simple`` — the simple env driven by the full ASMC + hydrodynamics
— port of ``usv_tpu/envs/simple_asmc.py``.

Each env step runs ``n_compute_calls * n_substeps`` (2 x 10) substeps of
{ASMC @ 100 Hz -> Fossen dynamics}, then defers observation, reward and
termination to the base simple env with a zero action.

Reference quirk kept by default (``double_integrate_compat=True``): the base
step is called with ``update_position=True`` (reference
``simple_env_asmc.py:27``), so the kinematic update also moves the boat on
top of the hydrodynamic integration. Set the flag False for the physically
clean variant.
"""

from __future__ import annotations

import dataclasses

import torch

from usv_tpu_torch.control.asmc import (
    AsmcGains,
    AsmcLoopState,
    AsmcState,
    asmc_compute,
    init_asmc,
)
from usv_tpu_torch.envs import simple
from usv_tpu_torch.envs.types import reset_from_generator
from usv_tpu_torch.envs.simple import SimpleEnvConfig, SimpleEnvState
from usv_tpu_torch.physics.dynamics import DynamicsState
from usv_tpu_torch.physics.params import VehicleParams


@dataclasses.dataclass(frozen=True)
class SimpleAsmcEnvConfig(SimpleEnvConfig):
    max_episode_steps: int = 1000  # gym_usv/__init__.py:30-34
    n_compute_calls: int = 2       # simple_env_asmc.py:19
    n_substeps: int = 10           # control/usv_asmc.py:56
    substep_dt: float = 0.01
    double_integrate_compat: bool = True
    # The JAX config's scan unroll factor. The port's substep loop is a
    # Python loop with nothing to unroll: accepted so that configs carry
    # over, and ignored.
    substep_unroll: int = 1


@dataclasses.dataclass(frozen=True)
class SimpleAsmcEnvState:
    base: SimpleEnvState
    ctrl: AsmcState
    accel_last: torch.Tensor     # (B, 3) dynamics trapezoid memory
    eta_dot_last: torch.Tensor   # (B, 3)

    def replace(self, **changes) -> "SimpleAsmcEnvState":
        return dataclasses.replace(self, **changes)


n_uniform = simple.n_uniform


def reset_from_uniform(cfg: SimpleAsmcEnvConfig, u: torch.Tensor) -> SimpleAsmcEnvState:
    """Base reset + fresh controller and integrator (simple_env_asmc.py:14-16)
    from a ``(B, n_uniform(cfg))`` block of U[0, 1) draws."""
    base = simple.reset_from_uniform(cfg, u)
    z3 = torch.zeros_like(base.position)
    return SimpleAsmcEnvState(
        base=base,
        ctrl=init_asmc((u.shape[0],), device=u.device),
        accel_last=z3,
        eta_dot_last=z3,
    )


reset = reset_from_generator(reset_from_uniform, n_uniform)


def reset_obs(cfg: SimpleAsmcEnvConfig, state: SimpleAsmcEnvState):
    return simple.reset_obs(cfg, state.base)


def reset_info(cfg: SimpleAsmcEnvConfig, state: SimpleAsmcEnvState):
    """The base reset's info (simple_env_asmc.py:14-16 -> simple_env.py:303)."""
    return simple.reset_info(cfg, state.base)


def step(
    cfg: SimpleAsmcEnvConfig,
    state: SimpleAsmcEnvState,
    action,
    gains: AsmcGains = AsmcGains(),
    vparams: VehicleParams = VehicleParams(),
):
    """2 x {10 ASMC substeps}, then the base step with a zero action
    (reference :18-27). ``action`` is (B, 2) = (u_d, heading offset)."""
    loop = AsmcLoopState(
        ctrl=state.ctrl,
        dyn=DynamicsState(
            pose=state.base.position,
            vel=state.base.velocity,
            accel_last=state.accel_last,
            eta_dot_last=state.eta_dot_last,
        ),
        perturb_step=torch.zeros_like(state.base.step_count),
    )

    # The call boundary carries no controller or model state, so the
    # reference's n_compute_calls x {n_substeps} is one flat loop.
    loop, _, _ = asmc_compute(
        gains, vparams, loop, action,
        do_perturb=False,
        n_substeps=cfg.n_compute_calls * cfg.n_substeps,
        dt=cfg.substep_dt,
    )

    base = state.base.replace(position=loop.dyn.pose, velocity=loop.dyn.vel)
    base, ts = simple.step(
        cfg, base, torch.zeros_like(action),
        update_position=cfg.double_integrate_compat,
    )
    new_state = SimpleAsmcEnvState(
        base=base,
        ctrl=loop.ctrl,
        accel_last=loop.dyn.accel_last,
        eta_dot_last=loop.dyn.eta_dot_last,
    )
    return new_state, ts

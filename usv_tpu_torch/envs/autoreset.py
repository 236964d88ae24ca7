"""Auto-reset as a batched select — port of ``usv_tpu/envs/autoreset.py``'s
``make_autoreset_step``.

Every env steps every iteration; a fresh reset is computed for every row on
every step (full width, as in JAX) and ``torch.where(done, fresh, stepped)``
picks it into the rows that finished. SB3's convention: on done, ``obs`` is
the reset observation of the new episode and the old episode's last
observation is ``info["terminal_observation"]``.

Not ported yet: compacting the reset to the done rows only, and
``make_pooled_autoreset_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from usv_tpu_torch.envs.types import TimeStep


def _select(done, new, old):
    """Fieldwise ``where(done, new, old)``, ``done`` broadcast over the batch dim."""
    picked = {}
    for f in dataclasses.fields(old):
        a, b = getattr(new, f.name), getattr(old, f.name)
        d = done.reshape(done.shape + (1,) * (b.dim() - 1))
        picked[f.name] = torch.where(d, a, b)
    return dataclasses.replace(old, **picked)


def make_autoreset_step(
    cfg,
    step_fn: Callable,
    reset_from_uniform_fn: Callable,
    reset_obs_fn: Callable,
    n_uniform: int,
):
    """Wrap a batched env into an auto-resetting batched step.

    step_fn(cfg, state, action) -> (state, TimeStep);
    reset_from_uniform_fn(cfg, u (B, n_uniform)) -> state;
    reset_obs_fn(cfg, state) -> obs.

    Returns ``auto_step(state, action, generator=None, uniform=None)``. The
    fresh resets come from ``uniform`` when given (a test feeds JAX's draws),
    else from a ``torch.rand`` block drawn from ``generator``.
    """

    def auto_step(
        state,
        action,
        generator: Optional[torch.Generator] = None,
        uniform: Optional[torch.Tensor] = None,
    ):
        new_state, ts = step_fn(cfg, state, action)
        done = ts.done
        if uniform is None:
            if generator is None:
                raise ValueError("auto_step needs a generator or a uniform block")
            uniform = torch.rand(
                (done.shape[0], n_uniform), generator=generator,
                dtype=torch.float32, device=done.device,
            )
        fresh = reset_from_uniform_fn(cfg, uniform)

        out_state = _select(done, fresh, new_state)
        obs = torch.where(done[:, None], reset_obs_fn(cfg, fresh), ts.obs)
        info = dict(ts.info)
        info["terminal_observation"] = ts.obs
        return out_state, TimeStep(
            obs=obs,
            reward=ts.reward,
            terminated=ts.terminated,
            truncated=ts.truncated,
            info=info,
        )

    return auto_step

"""Auto-reset as a batched select — port of ``usv_tpu/envs/autoreset.py``.

Every env steps every iteration; finished envs are replaced by freshly
randomized ones with ``torch.where(done, fresh, stepped)`` over the state's
leaves. SB3's convention: on done, ``obs`` is the reset observation of the
new episode and the old episode's last observation is
``info["terminal_observation"]``.

Two forms, as in JAX:

* :func:`make_autoreset_step` computes a fresh reset for every row on every
  step (full width) and selects it into the rows that finished.
* :func:`make_pooled_autoreset_step` computes only ``F`` fresh states per
  step and hands the i-th done env pool entry ``cumsum(done) - 1``; a step
  with more than ``F`` done envs takes the full-width path, so every done env
  gets its own draw for any done pattern. JAX decides between the two paths
  with ``lax.cond`` on the device. Here the host decides, so the pooled step
  reads ``done.sum()`` back: one device-to-host synchronisation per step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from usv_tpu_torch.envs.types import TimeStep, tree_map
from usv_tpu_torch.timing import span


def _select(done, new, old):
    """Leafwise ``where(done, new, old)`` over (nested) states, ``done``
    broadcast over each leaf's trailing dimensions."""

    def pick(a, b):
        return torch.where(done.reshape(done.shape + (1,) * (b.dim() - 1)), a, b)

    return tree_map(pick, new, old)


def _draw(uniform, generator, rows, n_uniform, device):
    """The first ``rows`` rows of ``uniform`` when given (a test feeds JAX's
    draws), else a ``(rows, n_uniform)`` block drawn from ``generator``."""
    if uniform is not None:
        return uniform[:rows]
    if generator is None:
        raise ValueError("auto_step needs a generator or a uniform block")
    return torch.rand((rows, n_uniform), generator=generator, dtype=torch.float32, device=device)


def _timestep(ts, obs):
    info = dict(ts.info)
    info["terminal_observation"] = ts.obs
    return TimeStep(obs=obs, reward=ts.reward, terminated=ts.terminated,
                    truncated=ts.truncated, info=info)


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
        with span("usv.env.dynamics"):
            new_state, ts = step_fn(cfg, state, action)
        done = ts.done
        with span("usv.env.reset"):
            fresh = reset_from_uniform_fn(
                cfg, _draw(uniform, generator, done.shape[0], n_uniform, done.device))
            fresh_obs = reset_obs_fn(cfg, fresh)
        with span("usv.env.select"):
            out_state = _select(done, fresh, new_state)
            obs = torch.where(done[:, None], fresh_obs, ts.obs)
        return out_state, _timestep(ts, obs)

    return auto_step


def default_reset_pool(num_envs: int) -> int:
    """Default pool size: 0, the full-width select path everywhere, as in
    JAX. The pooled path stays an explicit opt-in
    (``BatchedEnv(..., reset_pool=F)``); ``PERF.md`` has its times on the
    card beside the full-width path's."""
    return 0


def make_pooled_autoreset_step(
    cfg,
    step_fn: Callable,
    reset_from_uniform_fn: Callable,
    reset_obs_fn: Callable,
    n_uniform: int,
    num_envs: int,
    fresh_per_step: int,
):
    """Batch-level auto-reset that computes ``fresh_per_step`` (F) fresh
    states per step instead of ``num_envs``.

    The i-th done env takes pool entry ``cumsum(done) - 1``, so each done env
    gets its own independent draw. When more than F envs finish in one step
    (the synchronized TimeLimit wave of a batch that was reset together) that
    step takes the exact full-width path, so the semantics match
    :func:`make_autoreset_step` in distribution for ANY done pattern.

    The choice between the two paths is made on the host from
    ``int(done.sum())``: the step waits for the device once. (Deciding a step
    late, or always taking the pool, would hand two done envs the same draw
    on a wave step.) The row gathers that deal pool entries to done rows cost
    one ``index_select`` per leaf.

    Returns ``auto_step(state, action, generator=None, uniform=None)`` over a
    leading env dimension of ``num_envs``. A ``uniform`` block has
    ``num_envs`` rows; the pooled path reads its first F.
    """
    F = int(min(max(1, fresh_per_step), num_envs))

    def auto_step(
        state,
        action,
        generator: Optional[torch.Generator] = None,
        uniform: Optional[torch.Tensor] = None,
    ):
        with span("usv.env.dynamics"):
            new_state, ts = step_fn(cfg, state, action)
        done = ts.done
        pooled = F < num_envs and int(done.sum()) <= F
        rows = F if pooled else num_envs
        with span("usv.env.reset"):
            fresh = reset_from_uniform_fn(cfg, _draw(uniform, generator, rows, n_uniform, done.device))
            fresh_obs = reset_obs_fn(cfg, fresh)
        with span("usv.env.select"):
            if pooled:
                idx = torch.clamp(torch.cumsum(done, dim=0) - 1, 0, F - 1)
                fresh = tree_map(lambda leaf: leaf.index_select(0, idx), fresh)
                fresh_obs = fresh_obs.index_select(0, idx)
            out_state = _select(done, fresh, new_state)
            obs = torch.where(done[:, None], fresh_obs, ts.obs)
        return out_state, _timestep(ts, obs)

    return auto_step

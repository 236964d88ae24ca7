"""Lockstep env batch — port of ``usv_tpu/vector/batch.py``.

The batch dimension that JAX gets from ``vmap`` is explicit in the port:
every env function already takes ``(B, ...)`` tensors. :class:`BatchedEnv`
binds one env family to a width, adds the auto-reset (full width or pooled),
the optional numerical guard and the optional rolling frame stack, and is the
entry point through which a learner or an adapter reaches an env.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from usv_tpu_torch.envs.autoreset import (
    default_reset_pool,
    make_autoreset_step,
    make_pooled_autoreset_step,
)
from usv_tpu_torch.envs.registry import EnvHandle
from usv_tpu_torch.timing import span
from usv_tpu_torch.utils.guards import make_sanitized_step
from usv_tpu_torch.vector.frames import init_frames, push_frames


@dataclasses.dataclass(frozen=True)
class BatchState:
    env: object                      # the env family's state, leading dim B
    frames: Optional[torch.Tensor]   # (B, S, obs_dim) rolling stack or None

    @property
    def stacked_obs(self):
        """(B, S * obs_dim) frame-stacked observation (oldest first, like
        gym.wrappers.FrameStack)."""
        if self.frames is None:
            raise ValueError("frame stacking disabled")
        b, s, d = self.frames.shape
        return self.frames.reshape(b, s * d)


class BatchedEnv:
    """A lockstep batch of one env family on the handle's device.

    >>> h = usv_tpu_torch.envs.make("usv-asmc-ca-v0")   # the card
    >>> benv = BatchedEnv(h, num_envs=4096, frame_stack=5)
    >>> state, obs = benv.reset(0)                      # a seed or a generator
    >>> state, ts = benv.step(state, actions)           # actions: (4096, 2)

    ``sanitize`` wraps the step in the numerical guard
    (``utils/guards.py``). ``reset_pool``: fresh resets computed per step;
    ``None`` takes :func:`default_reset_pool` (0: the full-width path), an
    explicit ``0 < F < num_envs`` opts into the pooled path
    (``envs/autoreset.py``).

    The generator given to (or made by) :meth:`reset` stays with the batch
    and feeds the resets of later steps, unless a step is handed its own or
    a ``uniform`` block.
    """

    def __init__(self, handle: EnvHandle, num_envs: int, frame_stack: int = 0,
                 sanitize: bool = False, reset_pool: Optional[int] = None):
        self.handle = handle
        self.cfg = handle.cfg
        self.device = handle.device
        self.num_envs = num_envs
        self.frame_stack = frame_stack
        self.generator: Optional[torch.Generator] = None

        step_fn = handle.step
        if sanitize:
            sanitized = make_sanitized_step(handle.step, self.cfg)

            def step_fn(cfg, state, action):
                return sanitized(state, action)

        n_uniform = handle.n_uniform(self.cfg)
        pool = default_reset_pool(num_envs) if reset_pool is None else reset_pool
        if pool and pool < num_envs:
            self._auto_step = make_pooled_autoreset_step(
                self.cfg, step_fn, handle.reset_from_uniform, handle.reset_obs,
                n_uniform, num_envs, pool,
            )
        else:
            self._auto_step = make_autoreset_step(
                self.cfg, step_fn, handle.reset_from_uniform, handle.reset_obs, n_uniform,
            )

    def reset(self, generator: Union[torch.Generator, int] = 0,
              uniform: Optional[torch.Tensor] = None):
        """Fresh envs -> ``(BatchState, obs)``. ``generator`` is a
        ``torch.Generator`` on the batch's device or a seed for a new one;
        with ``uniform`` (a ``(num_envs, n_uniform)`` block) the reset is its
        transform and nothing is drawn."""
        if not isinstance(generator, torch.Generator):
            seed = int(generator)
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        self.generator = generator
        if uniform is None:
            env_state = self.handle.reset(self.cfg, generator, self.num_envs, self.device)
        else:
            env_state = self.handle.reset_from_uniform(self.cfg, uniform)
        obs = self.handle.reset_obs(self.cfg, env_state)
        frames = init_frames(obs, self.frame_stack) if self.frame_stack else None
        return BatchState(env=env_state, frames=frames), obs

    def step(self, state: BatchState, actions,
             generator: Optional[torch.Generator] = None,
             uniform: Optional[torch.Tensor] = None):
        """One auto-resetting step of every env -> ``(BatchState, TimeStep)``."""
        with span("usv.env.step"):
            env_state, ts = self._auto_step(
                state.env, actions, self.generator if generator is None else generator, uniform)
            frames = state.frames
            if self.frame_stack:
                frames = push_frames(frames, ts.obs, ts.done)
            return BatchState(env=env_state, frames=frames), ts

"""Lockstep env batch — port of ``usv_tpu/vector/batch.py``.

The batch dimension that JAX gets from ``vmap`` is explicit in the port:
every env function already takes ``(B, ...)`` tensors. :class:`BatchedEnv`
binds one env family to a width, adds the full-width auto-reset, the
optional numerical guard and the optional rolling frame stack, and is the
entry point through which a learner or an adapter reaches an env.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from usv_tpu_torch.envs.autoreset import GraphedAutoResetStep, make_autoreset_step
from usv_tpu_torch.envs.registry import EnvHandle
from usv_tpu_torch.timing import env_step_counter, span
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
    (``utils/guards.py``).

    The generator given to (or made by) :meth:`reset` stays with the batch
    and feeds the resets of later steps, unless a step is handed its own or
    a ``uniform`` block.

    On the card the full-width step replays one CUDA graph per input
    signature (``envs/autoreset.py::GraphedAutoResetStep``), captured at its
    first step; CPU tensors, actions that carry autograd history and a step
    called inside another capture run the same step eagerly
    (``envs/autoreset.py::make_autoreset_step``).
    ``timing.env_step_counter`` counts the steps of each kind.
    """

    def __init__(self, handle: EnvHandle, num_envs: int, frame_stack: int = 0,
                 sanitize: bool = False):
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
        fns = (self.cfg, step_fn, handle.reset_from_uniform, handle.reset_obs, n_uniform)
        self._auto_step = make_autoreset_step(*fns)
        self._graphed = GraphedAutoResetStep(*fns)

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
        generator = self.generator if generator is None else generator
        if (isinstance(actions, torch.Tensor) and actions.is_cuda
                and not (actions.requires_grad and torch.is_grad_enabled())
                and not torch.cuda.is_current_stream_capturing()):
            # the phases run on the device, so no env span would time anything
            env_state, ts = self._graphed(state.env, actions, generator, uniform)
            env_step_counter.replayed += 1
            return self._batch_state(state, env_state, ts), ts
        with span("usv.env.step"):
            env_state, ts = self._auto_step(state.env, actions, generator, uniform)
            env_step_counter.eager += 1
            return self._batch_state(state, env_state, ts), ts

    def _batch_state(self, state, env_state, ts):
        frames = state.frames
        if self.frame_stack:
            frames = push_frames(frames, ts.obs, ts.done)
        return BatchState(env=env_state, frames=frames)

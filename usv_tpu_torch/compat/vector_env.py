"""gymnasium.vector.VectorEnv adapter over the lockstep env batch — port of
``usv_tpu/compat/vector_env.py``.

The reference's vector surface is SB3 ``DummyVecEnv``/``make_vec_env``
(sb3_train_vec.py:67); its gymnasium analog is ``gymnasium.vector.VectorEnv``.
This adapter exposes the port's ``BatchedEnv`` (auto-reset on the device,
optional frame stacking and numerical guard) through that standard API, so
host-side training loops written against gymnasium vector envs (or SB3's
VecEnv via its gymnasium bridge) can drive thousands of envs on the card from
one process: one step of the batch per call, its actions copied in and its
outputs copied out with one wait for the device.

One difference from the JAX module: without gymnasium this class still
constructs, resets and steps (as the single-env adapter does); it then
builds no spaces.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import gymnasium
    from gymnasium import spaces

    _BASE = gymnasium.vector.VectorEnv
except ImportError:
    gymnasium = None
    spaces = None

    class _BASE:
        """What the adapter uses of gymnasium's ``VectorEnv`` when it is
        absent."""

        metadata = {}

        def close(self, **kwargs):
            self.close_extras(**kwargs)

from usv_tpu_torch.compat.gym_adapter import to_device, to_host
from usv_tpu_torch.envs import make as make_functional
from usv_tpu_torch.vector.batch import BatchedEnv


class UsvVectorEnv(_BASE):
    """N lockstep envs of one family behind gymnasium's VectorEnv API, on the
    card unless ``device=`` names another device."""

    # SAME-step autoreset: the obs returned with done=True is already the
    # next episode's reset observation; the finished episode's final obs is
    # in infos (gymnasium's "final_obs" and SB3's "terminal_observation").
    metadata = {"render_modes": ["rgb_array"], "autoreset_mode": "SameStep"}

    def __init__(self, env_id: str = "usv-simple", num_envs: int = 256,
                 frame_stack: int = 0, seed: int = 0, sanitize: bool = False,
                 device=None, **config_overrides):
        self.handle = make_functional(env_id, device=device, **config_overrides)
        self.device = self.handle.device
        cfg = self.handle.cfg
        self.num_envs = num_envs
        self._benv = BatchedEnv(
            self.handle, num_envs, frame_stack=frame_stack, sanitize=sanitize
        )
        self._state = None
        self._seed_counter = seed
        self._frame_stack = frame_stack

        if gymnasium is not None:
            obs_dim = cfg.obs_dim * max(1, frame_stack)
            self.single_observation_space = spaces.Box(
                -np.inf, np.inf, shape=(obs_dim,), dtype=np.float32
            )
            self.single_action_space = spaces.Box(
                np.asarray(cfg.action_low, np.float32),
                np.asarray(cfg.action_high, np.float32),
                dtype=np.float32,
            )
            self.observation_space = gymnasium.vector.utils.batch_space(
                self.single_observation_space, num_envs
            )
            self.action_space = gymnasium.vector.utils.batch_space(
                self.single_action_space, num_envs
            )

    def _obs_out(self, ts_obs):
        return self._state.stacked_obs if self._frame_stack else ts_obs

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is None:
            self._seed_counter += 1
            seed = self._seed_counter
        self._state, obs = self._benv.reset(seed)
        return to_host(self._obs_out(obs), self.device), {}

    def step(self, actions):
        actions = to_device(
            np.reshape(actions, (self.num_envs, self.handle.cfg.action_dim)), self.device
        )
        self._state, ts = self._benv.step(self._state, actions)
        out = to_host({
            "obs": self._obs_out(ts.obs), "reward": ts.reward, "terminated": ts.terminated,
            "truncated": ts.truncated, "info": ts.info,
        }, self.device)
        # pass every vectorized info field through; the final observation is
        # published under both gymnasium's and SB3's conventional keys
        infos = out["info"]
        infos["final_obs"] = infos.get("terminal_observation", out["obs"])
        return out["obs"], out["reward"], out["terminated"], out["truncated"], infos

    def close_extras(self, **kwargs):
        pass

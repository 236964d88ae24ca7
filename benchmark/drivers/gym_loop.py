"""One env through the gymnasium API, as gym-usv's own users drive it (SB3
over ``gymnasium.make``): the port's adapter class on the card, in a closed
loop of ``step`` calls. Actions are uniform over the env's action space,
drawn on the host from the seed, as an exploring policy feeds them; a
finished episode is reset with a seed derived from the run's seed. Each
``step`` returns numpy, so each call waits for the card; each is timed on
the host clock, and resets are in the loop but not in the latencies.

The check follows the program from its own state: every reset of the run is
worked out again from its seed, and a sample of the window's steps, drawn
from the seed, from the state before them and their action.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness

ACTION_TAG, RESET_TAG, CHECK_TAG = 1, 2, 3
LIMITS = "env"


def program(config: dict, device):
    """The system under test: the port's gymnasium adapter class of the
    configuration, at its settings, on ``device``."""
    from usv_tpu_torch.compat import gym_adapter

    env = getattr(gym_adapter, config["gym_class"])(device=device, **config["env"])
    if env.handle.cfg.obs_dim != config["obs_dim"]:
        raise ValueError(f"{config['gym_class']}: obs_dim {env.handle.cfg.obs_dim}, "
                         f"the configuration states {config['obs_dim']}")
    return env


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, system=program):
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.env = system(config, self.device)
        self.rng = np.random.default_rng(harness.derived_seed(seed, ACTION_TAG))
        self.low = np.asarray(config["action_low"], np.float32)
        self.high = np.asarray(config["action_high"], np.float32)
        self.reset_seed = harness.derived_seed(seed, RESET_TAG)
        self.resets = []   # (seed, the observation reset returned)
        self._reset()
        for _ in range(traffic["warmup_steps"]):
            self._step(self._action())
        self.samples = harness.Reservoir(traffic["checked_steps"], harness.derived_seed(seed, CHECK_TAG))
        harness.synchronize(self.device)

    def _action(self):
        return self.rng.uniform(self.low, self.high).astype(np.float32)

    def _reset(self):
        seed = (self.reset_seed + len(self.resets)) % 2**63
        obs, _ = self.env.reset(seed=seed)
        self.resets.append((seed, obs))

    def _step(self, action):
        out = self.env.step(action)
        if out[2] or out[3]:
            self._reset()
        return out

    def window(self, seconds: float) -> dict:
        latencies = []
        harness.synchronize(self.device)
        opened = time.perf_counter()
        end = opened + seconds
        while True:
            action = self._action()
            place = self.samples.admit(len(latencies))
            before = self.env._state
            t = time.perf_counter()
            obs, reward, terminated, truncated, _ = self.env.step(action)
            latencies.append(time.perf_counter() - t)
            if place is not None:
                self.samples.put(place, (before, action, obs, reward, terminated, truncated,
                                         self.env._state))
            if terminated or truncated:
                self._reset()
            if time.perf_counter() >= end:
                break
        harness.synchronize(self.device)
        return {"opened_at": opened, "seconds": time.perf_counter() - opened,
                "latencies_s": latencies, "steps": len(latencies), "attempted": len(latencies)}

    def profile(self) -> harness.Slice:
        n = self.traffic["slice_steps"]

        def run():
            for _ in range(n):
                action = self._action()
                with record_function(harness.STEP_RANGE):
                    out = self.env.step(action)
                if out[2] or out[3]:
                    self._reset()

        return harness.profile_slice(run, n)

    def release(self):
        self.env = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self) -> dict:
        ref, cfg = harness.reference_of(self.config), self.config
        cmp = harness.Comparison(cfg["sensor_columns"])
        for seed, obs in self.resets:
            g = torch.Generator().manual_seed(int(seed))
            u = torch.rand((1, ref.n_uniform(cfg)), generator=g).to(self.device)
            cmp.obs(np.asarray(obs)[None], ref.reset_obs(cfg, ref.reset_from_uniform(cfg, u)))
        for before, action, obs, reward, terminated, truncated, after in self.samples.items:
            a = torch.as_tensor(action[None], device=self.device)
            want_state, want = ref.step(cfg, harness.as_float32(harness.flatten(before)), a)
            cmp.outputs({"obs": np.asarray(obs)[None], "reward": [reward],
                         "terminated": [terminated], "truncated": [truncated]}, want)
            cmp.state(harness.flatten(after), want_state)
        return cmp.readings()

"""Lockstep simulation: ``num_envs`` envs of one family in a closed loop
through ``BatchedEnv.step`` with the full-width auto-reset, as the
reference's own throughput protocol drives them (gym-usv
``tools/profile_env.py``: zero actions, every step's observation produced).

The window steps until ``seconds`` have passed on the host clock and ends
with a synchronize; every step of it counts. The check follows the program
from its own state: the start (the reset from the run's generator) and a
sample of the window's steps, drawn from the seed, are each worked out again
by the plain reference from the state before them and the generator's state
that their reset draws came from.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from benchmark import harness, roofline
from benchmark.reference.autoreset import auto_step

RESET_TAG, CHECK_TAG = 1, 2
LIMITS = "env"


def program(config: dict, num_envs: int, device):
    """The system under test: the port's ``BatchedEnv`` over its registry's
    env at the configuration's settings."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.vector import BatchedEnv

    handle = make(config["env_id"], device=device, **config["env"])
    if handle.cfg.obs_dim != config["obs_dim"]:
        raise ValueError(f"{config['env_id']}: obs_dim {handle.cfg.obs_dim}, "
                         f"the configuration states {config['obs_dim']}")
    return BatchedEnv(handle, num_envs)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, system=program):
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.num_envs = traffic["num_envs"]
        self.env = system(config, self.num_envs, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(harness.derived_seed(seed, RESET_TAG))
        self.start = self.generator.get_state()
        self.state, self.obs0 = self.env.reset(self.generator)
        self.state0 = self.state
        self.actions = torch.zeros((self.num_envs, len(config["action_low"])), device=self.device)
        for _ in range(traffic["warmup_steps"]):
            self.state, _ = self.env.step(self.state, self.actions)
        self.samples = harness.Reservoir(traffic["checked_steps"], harness.derived_seed(seed, CHECK_TAG))
        harness.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        state, steps = self.state, 0
        harness.synchronize(self.device)
        opened = time.perf_counter()
        end = opened + seconds
        while True:
            place = self.samples.admit(steps)
            if place is not None:
                before, drawn_from = state, self.generator.get_state()
            state, ts = self.env.step(state, self.actions)
            if place is not None:
                self.samples.put(place, (drawn_from, before, state, ts))
            steps += 1
            if time.perf_counter() >= end:
                break
        harness.synchronize(self.device)
        closed = time.perf_counter()
        self.state = state
        env_steps = steps * self.num_envs
        return {"opened_at": opened, "seconds": closed - opened, "steps": steps,
                "env_steps": env_steps, "attempted": env_steps}

    def _raycast_bound(self) -> dict:
        """The least time of one ray-cast launch on the state the slice starts
        from (its bytes bound it at these shapes)."""
        s = harness.flatten(self.state.env)
        pose, mask = s[self.config["pose_leaf"]], s["obs_mask"]
        lo, hi = self.config["sensor_columns"]
        R, (B, K) = hi - lo, mask.shape
        needed = roofline.needed_pairs(pose, s["obs_xy"], s["obs_r"], mask, R,
                                       self.config["env"]["sensor_span"])
        return dict(roofline.raycast_least_seconds(B, R, K, needed, int(mask.sum())),
                    shape=[B, R, K], needed_pairs=needed)

    def profile(self) -> harness.Slice:
        n = self.traffic["slice_steps"]
        bound = self._raycast_bound()

        def run():
            for _ in range(n):
                with record_function(harness.STEP_RANGE):
                    self.state, _ = self.env.step(self.state, self.actions)

        traced = harness.profile_slice(run, n)
        traced.extra["raycast"] = bound
        return traced

    def release(self):
        self.env = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self) -> dict:
        ref, cfg = harness.reference_of(self.config), self.config
        cmp = harness.Comparison(cfg["sensor_columns"])
        g = torch.Generator(device=self.device)
        shape = (self.num_envs, ref.n_uniform(cfg))

        def draw(state):
            g.set_state(state)
            return torch.rand(shape, generator=g, dtype=torch.float32, device=self.device)

        start = ref.reset_from_uniform(cfg, draw(self.start))
        cmp.obs(self.obs0, ref.reset_obs(cfg, start))
        cmp.state(harness.flatten(self.state0.env), start)
        for drawn_from, before, after, ts in self.samples.items:
            got = {"obs": ts.obs, "reward": ts.reward, "terminated": ts.terminated,
                   "truncated": ts.truncated}
            want_state, want = auto_step(ref, cfg, harness.as_float32(harness.flatten(before.env)),
                                         self.actions, draw(drawn_from))
            cmp.outputs(got, want)
            cmp.state(harness.flatten(after.env), want_state)
        return cmp.readings()

"""The robust SAC population: the port's ``SacLearner`` at the
configuration's ``learner`` settings trained as ``population`` independent
learners in one program (``run_sac --recipe robust``: 4 x 1024 envs, a
round of 64 collect steps and 16 fused updates at batch 1024 a member, one
vmapped call a network and one Adam over the stacked parameters), driven
round by round through ``SacLearner.train_rounds_many(ps, 1)``.

Set-up builds the population from seeds ``seed .. seed + S - 1``
(``SacLearner.init_many``), loads into member ``i`` weights the benchmark
makes from ``derived_seed(seed, WEIGHT_TAG + i)``, and runs the first
``checked_rounds`` rounds through the window's own call: the first passes
``learning_starts`` (49 of its 64 collect steps take uniform actions), the
second is a steady round of the policies' own. The window then runs whole
rounds until ``seconds`` have passed on the host clock and ends with a
synchronize; every round counts, each ``S x train_freq x num_envs``
env-steps.

The check holds every member, over those rounds, against the plain
reference (``benchmark/reference/sac_population.py``): from the member's part
of the state at each round's edge, every row of its replay block the round
wrote, its frame stack at the round's end, its actions, each leaf's change
over the round and each leaf's Adam first moment at its end, by
``sac_train``'s numbers and rules; and each member's first frame stack
against the reset its seed draws.
"""

from __future__ import annotations

import statistics
import time

import torch
from torch.profiler import record_function

from benchmark import harness, roofline
from benchmark.drivers.sac_train import FIELDS, WEIGHT_TAG, gap, program, worst_leaf
from benchmark.reference import sac as ref_sac
from benchmark.reference import sac_population as ref_pop

LIMITS = "sac"
# sac_train's numbers and the rays' share: the reference actor reads the
# program's stored observations, so the rays are held here on their own
NAMES = ("obs_gap", "ray_miss_share", "action_gap", "replay_gap", "moment_gap", "param_change_gap")


def optimized(ps):
    """(name, optimizer, stacked parameter) of every leaf the population
    optimizes, under the plain learner's names."""
    out = [(f"{net}.{name}", opt, p) for net, opt in (("actor", ps.actor_opt), ("critic", ps.critic_opt))
           for name, p in zip(getattr(ps, net).names, getattr(ps, net).params)]
    return out + [("log_alpha", ps.alpha_opt, ps.log_alpha)]


def edge(ps) -> dict:
    """A copy of what the check reads of the population between two rounds,
    in the reference's layout (``sac_population``'s docstring)."""
    leaves = {name: p.detach().clone() for name, _, p in optimized(ps)}
    leaves.update({f"target.{name}": p.detach().clone()
                   for name, p in zip(ps.target_critic.names, ps.target_critic.params)})
    adam, steps = {}, set()
    for name, opt, p in optimized(ps):
        state = opt.state.get(p)
        if state:
            adam[name] = (state["exp_avg"].detach().clone(), state["exp_avg_sq"].detach().clone())
            steps.add(int(state["step"]))
    if len(steps) > 1:
        raise ValueError(f"the optimizers' step counts differ: {sorted(steps)}")
    return {"leaves": leaves, "adam": adam, "t": steps.pop() if steps else 0,
            "generators": [g.get_state() for g in ps.generators],
            "env": {k: v.clone() for k, v in harness.flatten(ps.batch.env).items()},
            "frames": ps.batch.frames.clone(),
            "sde": (ps.sde.exploration_mat.clone(), ps.sde.step.clone()),
            "fill": ps.buffer.size, "env_steps": ps.env_steps}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, system=program):
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.seed = seed
        S = config["learner"]["population"]
        self.learner = system(config, self.device)
        self.ps = self.learner.init_many([seed + i for i in range(S)])
        with torch.no_grad():
            for i in range(S):
                g = torch.Generator(device=self.device)
                g.manual_seed(harness.derived_seed(seed, WEIGHT_TAG + i))
                weights = ref_sac.make_weights(config, g, self.device)
                for stack, net in ((self.ps.actor, "actor"), (self.ps.critic, "critic"),
                                   (self.ps.target_critic, "critic")):
                    for name, p in zip(stack.names, stack.params):
                        p[i].copy_(weights[net][name])
        self.edges = [edge(self.ps)]
        for _ in range(traffic["checked_rounds"]):
            self.ps, _ = self.learner.train_rounds_many(self.ps, 1)
            self.edges.append(edge(self.ps))
        # the checked rounds' rows, kept on the host: later rounds overwrite them
        rows = self.edges[-1]["fill"]
        self.replay = {name: getattr(self.ps.buffer, name)[:, :rows].to("cpu", copy=True)
                       for name in FIELDS}
        harness.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        rounds = 0
        harness.synchronize(self.device)
        opened = time.perf_counter()
        end = opened + seconds
        while True:
            self.ps, _ = self.learner.train_rounds_many(self.ps, 1)
            rounds += 1
            if time.perf_counter() >= end:
                break
        harness.synchronize(self.device)
        L = self.config["learner"]
        env_steps = rounds * L["population"] * L["train_freq"] * L["num_envs"]
        return {"opened_at": opened, "seconds": time.perf_counter() - opened, "rounds": rounds,
                "env_steps": env_steps, "attempted": env_steps,
                "round_flops": L["population"] * roofline.sac_round_flops(self.config)}

    def profile(self) -> harness.Slice:
        n = self.traffic["slice_rounds"]
        s = harness.flatten(self.ps.batch.env)
        lo, hi = self.config["sensor_columns"]
        B, K = s["obs_mask"].shape
        needed = roofline.needed_pairs(s[self.config["pose_leaf"]], s["obs_xy"], s["obs_r"],
                                       s["obs_mask"], hi - lo, self.config["env"]["sensor_span"])
        bound = dict(roofline.raycast_least_seconds(B, hi - lo, K, needed, int(s["obs_mask"].sum())),
                     shape=[B, hi - lo, K], needed_pairs=needed)

        def run():
            for _ in range(n):
                with record_function(harness.STEP_RANGE):
                    self.ps, _ = self.learner.train_rounds_many(self.ps, 1)

        traced = harness.profile_slice(run, n)
        traced.extra["raycast"] = bound
        return traced

    def release(self):
        self.learner = self.ps = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def _check_start(self, i: int, dtype, cmp: harness.Comparison):
        """Member ``i``'s first frame stack against the reset the reference
        draws from its seed (its generator is seeded with it)."""
        cfg, B = self.config, self.config["learner"]["num_envs"]
        env = harness.reference_of(cfg)
        g = torch.Generator(device=self.device)
        g.manual_seed(int(self.seed) + i)
        u = torch.rand((B, env.n_uniform(cfg)), generator=g, dtype=torch.float32, device=self.device)
        obs = env.reset_obs(cfg, env.reset_from_uniform(cfg, u.to(dtype)))
        frames, dim = ref_pop.member(self.edges[0], i, B)["frames"], cfg["obs_dim"]
        cmp.obs(frames.reshape(-1, dim), obs[:, None].expand_as(frames).reshape(-1, dim))

    def _check_round(self, before: dict, after: dict, replay: dict, dtype,
                     cmp: harness.Comparison, readings: dict):
        """One member's round from its part of the state at the round's edges:
        its collect against the rows it wrote, then its updates against its
        leaves and Adam state at the round's end."""
        ref = ref_pop.Member(self.config, before, harness.reference_of(self.config), dtype)
        L, dim = self.config["learner"], self.config["obs_dim"]
        B, T = L["num_envs"], L["train_freq"]
        g = torch.Generator(device=self.device)
        g.set_state(before["generator"])
        rows = slice(before["fill"], before["fill"] + T * B)
        got = {name: replay[name][rows].reshape(T, B, *replay[name].shape[1:]) for name in FIELDS}
        want = ref.collect(g, got["action"], got["obs"])
        readings["action_gap"] = max(readings["action_gap"], gap(got["action"], want["action"]))
        for name in ("obs", "next_obs"):
            cmp.obs(got[name].reshape(-1, dim), want[name].reshape(-1, dim))
        readings["replay_gap"] = max(readings["replay_gap"], gap(got["reward"], want["reward"]),
                                     gap(got["done"], want["done"]))
        cmp.obs(after["frames"].reshape(-1, dim), want["frames"].reshape(-1, dim))

        learner = ref.updates(g, replay, after["fill"])
        if learner is None:
            return
        first = {k: float(v.float().norm()) for k, v in learner.first_grads.items()}
        want_m = {k: float(v.float().norm()) for k, v in learner.first_moments().items()}
        got_m = {k: float(after["adam"][k][0].norm()) if k in after["adam"] else 0.0 for k in want_m}
        readings["moment_gap"] = max(readings["moment_gap"], worst_leaf(got_m, want_m, want_m))
        start = before["leaves"]
        moved = {k: float((v.float() - start[k]).norm()) for k, v in learner.leaves().items()}
        got_c = {k: float((after["leaves"][k] - start[k]).norm()) for k in moved}
        # sac_train's rule: leaves whose reference gradient is nought to
        # rounding move under Adam by round-off alone, so only those over a
        # thousandth of the median leaf's are held
        median = statistics.median(first.values())
        kept = [k for k in moved if first.get(k.replace("target.", "critic."), median) > 1e-3 * median]
        readings["param_change_gap"] = max(readings["param_change_gap"], worst_leaf(
            {k: got_c[k] for k in kept}, {k: moved[k] for k in kept}, moved))

    def check(self, dtype=torch.float32) -> dict:
        """The comparison's numbers over every member and checked round, the
        reference computed in ``dtype`` (a lower precision is the control)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.config
        S, B = cfg["learner"]["population"], cfg["learner"]["num_envs"]
        cmp = harness.Comparison(cfg["sensor_columns"])
        readings = dict.fromkeys(("action_gap", "replay_gap", "moment_gap", "param_change_gap"), 0.0)
        for i in range(S):
            self._check_start(i, dtype, cmp)
            replay = {name: value[i].to(self.device) for name, value in self.replay.items()}
            for before, after in zip(self.edges, self.edges[1:]):
                self._check_round(ref_pop.member(before, i, B), ref_pop.member(after, i, B), replay,
                                  dtype, cmp, readings)
        readings.update(cmp.readings())
        return {k: readings[k] for k in NAMES}

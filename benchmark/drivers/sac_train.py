"""SAC training: the port's ``SacLearner`` at the configuration's ``learner``
settings (``run_sac --recipe at-scale``: 1024 envs, a round of 64 collect
steps and 16 fused updates at batch 1024), driven round by round through
``SacLearner.train_rounds(ts, 1)``.

Set-up builds one train state, loads into it weights the benchmark makes from
the seed, and runs the first ``checked_rounds`` rounds through the window's
own call: the first passes ``learning_starts`` (49 of its 64 collect steps
take uniform actions), the second is a steady round of the policy's own. The
window then runs whole rounds until ``seconds`` have passed on the host clock
and ends with a synchronize; every round counts.

The check reads only what the train state exposes, at the edges of those
rounds: the parameters, Adam's state, the generator's state, the env batch,
the frame stack, the gSDE state and the replay rows. The plain reference
works out again from the seed the start's observations, and follows each
checked round from the state the program started it from: every collect step
(the gSDE draws, the actor's action, the env step and auto-reset driven by
the action the program wrote, the frame stack and the rows written), then
every update (the replay draws, the losses, the gradients, Adam, the soft
target update). It compares every row the round wrote and the frame stack at
its end, each leaf's change over the round and each leaf's Adam first moment
at its end.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch
from torch.profiler import record_function

from benchmark import harness, roofline
from benchmark.reference import sac as ref_sac
from benchmark.reference.autoreset import auto_step

WEIGHT_TAG = 1
LIMITS = "sac"
FIELDS = ("obs", "action", "reward", "next_obs", "done")
# The env step's ray share, reward, state and flag numbers are not compared
# here: neither the TF32 control nor a planted learner fault moves them (the
# env cells compare them); the replay rows carry the step's reward and flags.
NAMES = ("obs_gap", "action_gap", "replay_gap", "moment_gap", "param_change_gap")


def sac_config(config: dict):
    """The port's ``SacConfig`` at the configuration's ``learner`` settings."""
    from usv_tpu_torch.train.sac import SacConfig

    L = config["learner"]
    names = {f.name for f in dataclasses.fields(SacConfig)}
    kw = {k: (tuple(v) if k == "hidden" else v) for k, v in L.items() if k in names}
    return SacConfig(**kw)


def program(config: dict, device):
    """The system under test: the port's ``SacLearner`` on its registry's env."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.sac import SacLearner

    return SacLearner(make(config["env_id"], device=device, **config["env"]), sac_config(config))


def optimized(ts):
    """(name, optimizer, parameter) of every leaf the train state optimizes."""
    out = [(f"{net}.{k}", opt, p) for net, opt in (("actor", ts.actor_opt), ("critic", ts.critic_opt))
           for k, p in getattr(ts, net).named_parameters()]
    return out + [("log_alpha", ts.alpha_opt, ts.log_alpha)]


def edge(learner, ts) -> dict:
    """A copy of what the check reads of the train state between two rounds."""
    leaves = {name: p.detach().clone() for name, _, p in optimized(ts)}
    leaves.update({f"target.{k}": v.detach().clone()
                   for k, v in ts.target_critic.named_parameters()})
    adam, steps = {}, set()
    for name, opt, p in optimized(ts):
        state = opt.state.get(p)
        if state:
            adam[name] = (state["exp_avg"].detach().clone(), state["exp_avg_sq"].detach().clone())
            steps.add(int(state["step"]))
    if len(steps) > 1:
        raise ValueError(f"the optimizers' step counts differ: {sorted(steps)}")
    return {"leaves": leaves, "adam": adam, "t": steps.pop() if steps else 0,
            "generator": ts.generator.get_state(),
            "env": {k: v.clone() for k, v in harness.flatten(ts.batch.env).items()},
            "frames": ts.batch.frames.clone(),
            "sde": (ts.sde.exploration_mat.clone(), ts.sde.step.clone()),
            "fill": learner.fill(ts), "env_steps": ts.env_steps}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, system=program):
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.seed = seed
        self.learner = system(config, self.device)
        self.ts = self.learner.init(seed)
        g = torch.Generator(device=self.device)
        g.manual_seed(harness.derived_seed(seed, WEIGHT_TAG))
        self.weights = ref_sac.make_weights(config, g, self.device)
        with torch.no_grad():
            self.ts.actor.load_state_dict(self.weights["actor"])
            self.ts.critic.load_state_dict(self.weights["critic"])
            self.ts.target_critic.load_state_dict(self.weights["critic"])
        self.edges = [edge(self.learner, self.ts)]
        for _ in range(traffic["checked_rounds"]):
            self.ts, _ = self.learner.train_rounds(self.ts, 1)
            self.edges.append(edge(self.learner, self.ts))
        # the checked rounds' rows, kept on the host: later rounds overwrite them
        rows = self.edges[-1]["fill"]
        self.replay = {name: getattr(self.ts.buffer, name)[:rows].to("cpu", copy=True)
                       for name in FIELDS}
        harness.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        rounds = 0
        harness.synchronize(self.device)
        opened = time.perf_counter()
        end = opened + seconds
        while True:
            self.ts, _ = self.learner.train_rounds(self.ts, 1)
            rounds += 1
            if time.perf_counter() >= end:
                break
        harness.synchronize(self.device)
        L = self.config["learner"]
        env_steps = rounds * L["train_freq"] * L["num_envs"]
        return {"opened_at": opened, "seconds": time.perf_counter() - opened, "rounds": rounds,
                "env_steps": env_steps, "attempted": env_steps,
                "round_flops": roofline.sac_round_flops(self.config)}

    def profile(self) -> harness.Slice:
        n = self.traffic["slice_rounds"]
        s = harness.flatten(self.ts.batch.env)
        lo, hi = self.config["sensor_columns"]
        B, K = s["obs_mask"].shape
        needed = roofline.needed_pairs(s[self.config["pose_leaf"]], s["obs_xy"], s["obs_r"],
                                       s["obs_mask"], hi - lo, self.config["env"]["sensor_span"])
        bound = dict(roofline.raycast_least_seconds(B, hi - lo, K, needed, int(s["obs_mask"].sum())),
                     shape=[B, hi - lo, K], needed_pairs=needed)

        def run():
            for _ in range(n):
                with record_function(harness.STEP_RANGE):
                    self.ts, _ = self.learner.train_rounds(self.ts, 1)

        traced = harness.profile_slice(run, n)
        traced.extra["raycast"] = bound
        return traced

    def release(self):
        self.learner = self.ts = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def _check_start(self, cmp: harness.Comparison):
        """The start's frame stack against the reset the reference draws from
        the seed (the learner's generator is seeded with it)."""
        cfg, B = self.config, self.config["learner"]["num_envs"]
        env = harness.reference_of(cfg)
        g = torch.Generator(device=self.device)
        g.manual_seed(int(self.seed))
        u = torch.rand((B, env.n_uniform(cfg)), generator=g, dtype=torch.float32, device=self.device)
        obs = env.reset_obs(cfg, env.reset_from_uniform(cfg, u))
        frames, dim = self.edges[0]["frames"], cfg["obs_dim"]
        cmp.obs(frames.reshape(-1, dim), obs[:, None].expand_as(frames).reshape(-1, dim))

    @torch.no_grad()
    def _follow_collect(self, before: dict, after: dict, replay: dict, generator,
                        cmp: harness.Comparison, readings: dict):
        """The round's collect steps from ``before``; the program's actions
        drive the reference env, the reference actor's are compared with them."""
        cfg, L = self.config, self.config["learner"]
        env, actor = harness.reference_of(cfg), ref_sac.Actor(cfg)
        B, T, dim = L["num_envs"], L["train_freq"], cfg["obs_dim"]
        warmup = -(-L["learning_starts"] // B)
        low, high = (torch.tensor(cfg[k], device=self.device) for k in ("action_low", "action_high"))
        w_actor = {k[len("actor."):]: v for k, v in before["leaves"].items() if k.startswith("actor.")}
        state, frames = harness.as_float32(before["env"]), before["frames"]
        mat, sde_step = before["sde"]
        for t in range(T):
            normals = torch.randn(mat.shape, generator=generator, device=self.device)
            mat = torch.where((sde_step % L["sde_sample_freq"] == 0)[:, None, None], normals, mat)
            sde_step = sde_step + 1
            obs = frames.reshape(B, -1)
            if before["env_steps"] + t < warmup:
                u = torch.rand((B, len(cfg["action_low"])), generator=generator, device=self.device)
                action = u * (high - low) + low
            else:
                action = actor.sample_sde(w_actor, obs, mat)
            reset = torch.rand((B, env.n_uniform(cfg)), generator=generator, dtype=torch.float32,
                               device=self.device)
            rows = slice(before["fill"] + t * B, before["fill"] + (t + 1) * B)
            got = {name: replay[name][rows] for name in FIELDS}
            readings["action_gap"] = max(readings["action_gap"], gap(got["action"], action))
            state, out = auto_step(env, cfg, state, got["action"], reset, guard_bound=L["guard_bound"])
            next_obs = torch.cat([frames[:, 1:], out["terminal_obs"][:, None]], 1)
            cmp.obs(got["obs"].reshape(-1, dim), frames.reshape(-1, dim))
            cmp.obs(got["next_obs"].reshape(-1, dim), next_obs.reshape(-1, dim))
            readings["replay_gap"] = max(readings["replay_gap"], gap(got["reward"], out["reward"]),
                                         gap(got["done"], out["terminated"].float()))
            done = out["terminated"] | out["truncated"]
            pushed = torch.cat([frames[:, 1:], out["obs"][:, None]], 1)
            frames = torch.where(done[:, None, None], out["obs"][:, None].expand_as(pushed), pushed)
        cmp.obs(after["frames"].reshape(-1, dim), frames.reshape(-1, dim))

    def _follow_updates(self, before: dict, after: dict, replay: dict, generator, readings: dict):
        """The round's updates from ``before``'s parameters and Adam state."""
        cfg, L = self.config, self.config["learner"]
        fill = after["fill"]
        if fill < min(L["learning_starts"], L["buffer_size"]):
            return
        learner = ref_sac.Learner(cfg, before["leaves"], before["adam"], before["t"])
        batch = L["batch_size"] * L["update_fusion"]
        obs_dim, act = cfg["obs_dim"] * L["frame_stack"], len(cfg["action_low"])
        for _ in range(L["gradient_steps"] // L["update_fusion"]):
            idx = torch.randint(0, fill, (batch,), generator=generator, device=self.device)
            noise = [torch.randn((batch, d), generator=generator, device=self.device)
                     for d in (act, act, obs_dim)]
            learner.update({name: value.index_select(0, idx) for name, value in replay.items()}, *noise)
        first = {k: float(v.norm()) for k, v in learner.first_grads.items()}
        want = {k: float(v.norm()) for k, v in learner.first_moments().items()}
        got = {k: float(after["adam"][k][0].norm()) if k in after["adam"] else 0.0 for k in want}
        readings["moment_gap"] = max(readings["moment_gap"], worst_leaf(got, want, want))
        start = before["leaves"]
        moved = {k: float((v - start[k]).norm()) for k, v in learner.leaves().items()}
        got = {k: float((after["leaves"][k] - start[k]).norm()) for k in moved}
        # leaves whose reference gradient is nought to rounding move under Adam
        # by round-off alone: the rule keeps those over a thousandth of the median
        median = statistics.median(first.values())
        kept = [k for k in moved if first.get(k.replace("target.", "critic."), median) > 1e-3 * median]
        readings["param_change_gap"] = max(readings["param_change_gap"], worst_leaf(
            {k: got[k] for k in kept}, {k: moved[k] for k in kept}, moved))

    def check(self) -> dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cmp = harness.Comparison(self.config["sensor_columns"])
        readings = dict.fromkeys(("action_gap", "replay_gap", "moment_gap", "param_change_gap"), 0.0)
        replay = {name: value.to(self.device) for name, value in self.replay.items()}
        self._check_start(cmp)
        for before, after in zip(self.edges, self.edges[1:]):
            g = torch.Generator(device=self.device)
            g.set_state(before["generator"])
            self._follow_collect(before, after, replay, g, cmp, readings)
            self._follow_updates(before, after, replay, g, readings)
        readings.update(cmp.readings())
        return {k: readings[k] for k in NAMES}


def gap(got, want) -> float:
    """The largest |difference| (a NaN reads as infinitely far)."""
    diff = (got.to(want.device).float() - want.float()).abs()
    return float(torch.nan_to_num(diff, nan=float("inf")).max())


def worst_leaf(got: dict, want: dict, scale_from: dict) -> float:
    """The largest |got norm - reference norm| over the leaves, each against
    the larger of its reference norm and the median leaf's."""
    median = statistics.median(scale_from.values())
    return max(abs(got[k] - want[k]) / max(want[k], median) for k in want)

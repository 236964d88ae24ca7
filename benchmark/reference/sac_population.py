"""Plain reference of the seed population the ``sac_population`` traffic runs
(``run_sac --recipe robust``): S independent SAC learners, each of them the
plain learner of ``sac.py`` (its ``Actor``, ``critic``, ``Adam`` and
``Learner``) with envs, a replay and a random stream of its own.

A population state here is a dict whose tensors hold every member's part:
``leaves`` (every trained tensor under ``sac.Learner.leaves``' names) and
``adam`` (each optimized leaf's ``(m, v)``) with the member axis first;
``t``, the updates made, ``fill``, the rows in each member's replay, and
``env_steps``, the collect steps taken, shared, since every member takes every
step; ``generators``, one generator state a member; and ``env`` (a dict of
leaves), ``frames`` and ``sde`` (the exploration matrices and their step
counters), whose rows are member-major: member ``i`` owns rows
``[i * B, (i + 1) * B)``. Each member's replay is a block of its own.
:func:`member` cuts member ``i``'s part out of such a state, and
:class:`Member` follows one round of that learner from it, on its own: no
``vmap``, no stacked parameters and no kernel.

Departures from the published SAC (gym-usv ``train_test/config.py``: SB3
SAC, gSDE, the CAPS terms), each the recipe's:
- S learners train side by side from seeds ``s, s+1, ...``; SB3 trains one
  a process.
- A round is ``train_freq`` lockstep collect steps of every env, then
  ``gradient_steps / update_fusion`` updates, each on ``update_fusion x
  batch_size`` rows: the recipe fuses 4 gradient steps into one.
- Every env's gSDE matrix is resampled where its own step counter meets
  ``sde_sample_freq``; the lockstep envs keep one schedule, as SB3's does.
- Each replay holds ``buffer_size`` rows rounded up to a whole number of
  rounds' rows (100,000 -> 131,072 at 64 x 1024 a round).
- The rest is ``sac.py``'s: warm-up actions uniform in the bounds, the
  marginal std with 1e-6 under its root, the terminal observation in
  ``next_obs`` and ``done`` the termination alone.

The comparison feeds each part its input from what the program wrote: the
reference actor reads the observation row the program stored, and the
reference env steps on the action the program stored (the actor's own action
is compared with it). So a rounding apart in an action, or a ray read apart
at a tangency, does not send the two learners apart; the reference's own
frames are compared with the stored rows. ``dtype`` computes the reference in
a lower precision, the control of that comparison: every draw is made in
float32 from the member's stream, as the program makes it, then cast.
"""

from __future__ import annotations

import torch

from benchmark.reference import sac as ref_sac
from benchmark.reference.autoreset import auto_step


def member(state: dict, i: int, rows: int) -> dict:
    """Member ``i``'s part of a population ``state`` (the layout above), each
    of its envs ``rows`` envs: the state of one plain learner."""
    block = slice(i * rows, (i + 1) * rows)
    mat, step = state["sde"]
    return {"leaves": {k: v[i] for k, v in state["leaves"].items()},
            "adam": {k: (m[i], v[i]) for k, (m, v) in state["adam"].items()},
            "t": state["t"], "generator": state["generators"][i],
            "env": {k: v[block] for k, v in state["env"].items()},
            "frames": state["frames"][block], "sde": (mat[block], step[block]),
            "fill": state["fill"], "env_steps": state["env_steps"]}


def cast(x, dtype):
    return x.to(dtype) if x.is_floating_point() else x


def actor_in(config: dict, dtype) -> ref_sac.Actor:
    """``sac.Actor`` whose action bounds are in ``dtype``, so that its scaled
    actions, which the critic reads, stay in it."""
    actor = ref_sac.Actor(config)
    actor.low, actor.high = actor.low.to(dtype), actor.high.to(dtype)
    return actor


class Member:
    """One learner of the population from its part (:func:`member`), in
    ``dtype``; ``env`` is the env family's reference module."""

    def __init__(self, config: dict, part: dict, env, dtype=torch.float32):
        self.config, self.L, self.env, self.dtype = config, config["learner"], env, dtype
        self.part = part
        self.leaves = {k: cast(v, dtype) for k, v in part["leaves"].items()}

    def _draw(self, fn, shape, generator, device):
        return fn(shape, generator=generator, device=device).to(self.dtype)

    @torch.no_grad()
    def collect(self, generator, actions, observations) -> dict:
        """The round's ``train_freq`` collect steps from the part's env rows,
        frame stack and gSDE rows, drawing from ``generator`` (the member's
        stream at the round's start); at step ``t`` the actor reads
        ``observations[t]`` and the env steps on ``actions[t]`` (each ``(T,
        B, ...)``). -> ``action`` (the actor's own), ``obs``,
        ``next_obs``, ``reward``, ``done`` (each ``(T, B, ...)``: the rows the
        learner writes) and ``frames``, the stack at the round's end."""
        cfg, L, env, dt, part = self.config, self.L, self.env, self.dtype, self.part
        frames = cast(part["frames"], dt)
        B, dev = frames.shape[0], frames.device
        warmup = -(-L["learning_starts"] // B)
        low, high = (torch.tensor(cfg[k], device=dev) for k in ("action_low", "action_high"))
        w_actor = {k[len("actor."):]: v for k, v in self.leaves.items() if k.startswith("actor.")}
        actor = actor_in(cfg, dt)
        state = {k: cast(v, dt) for k, v in part["env"].items()}
        mat, sde_step = cast(part["sde"][0], dt), part["sde"][1]
        out = {k: [] for k in ("action", "obs", "next_obs", "reward", "done")}
        for t in range(L["train_freq"]):
            normals = self._draw(torch.randn, mat.shape, generator, dev)
            mat = torch.where((sde_step % L["sde_sample_freq"] == 0)[:, None, None], normals, mat)
            sde_step = sde_step + 1
            obs = frames.reshape(B, -1)
            if part["env_steps"] + t < warmup:
                u = torch.rand((B, len(cfg["action_low"])), generator=generator, device=dev)
                action = u * (high - low) + low
            else:
                action = actor.sample_sde(w_actor, cast(observations[t], dt), mat)
            reset = self._draw(torch.rand, (B, env.n_uniform(cfg)), generator, dev)
            state, step = auto_step(env, cfg, state, cast(actions[t], dt), reset,
                                    guard_bound=L["guard_bound"])
            next_obs = torch.cat([frames[:, 1:], step["terminal_obs"][:, None]], 1)
            for name, value in (("action", action), ("obs", obs), ("next_obs", next_obs.reshape(B, -1)),
                                ("reward", step["reward"]), ("done", step["terminated"].to(dt))):
                out[name].append(value)
            done = step["terminated"] | step["truncated"]
            pushed = torch.cat([frames[:, 1:], step["obs"][:, None]], 1)
            frames = torch.where(done[:, None, None], step["obs"][:, None].expand_as(pushed), pushed)
        return dict({k: torch.stack(v) for k, v in out.items()}, frames=frames)

    def updates(self, generator, replay: dict, fill: int):
        """The round's updates from the part's parameters and Adam state, on
        the member's own replay block ``replay`` (rows ``[0, fill)``),
        drawing from ``generator`` where the collect left it. -> the plain
        ``sac.Learner`` after them, or ``None`` where the fill has not
        reached ``learning_starts``."""
        L, dt = self.L, self.dtype
        if fill < min(L["learning_starts"], L["buffer_size"]):
            return None
        adam = {k: (cast(m, dt), cast(v, dt)) for k, (m, v) in self.part["adam"].items()}
        learner = ref_sac.Learner(self.config, dict(self.leaves), adam, self.part["t"])
        learner.actor = actor_in(self.config, dt)
        batch = L["batch_size"] * L["update_fusion"]
        obs_dim, act = self.config["obs_dim"] * L["frame_stack"], len(self.config["action_low"])
        dev = replay["obs"].device
        for _ in range(L["gradient_steps"] // L["update_fusion"]):
            idx = torch.randint(0, fill, (batch,), generator=generator, device=dev)
            noise = [self._draw(torch.randn, (batch, d), generator, dev) for d in (act, act, obs_dim)]
            learner.update({k: cast(v.index_select(0, idx), dt) for k, v in replay.items()}, *noise)
        return learner

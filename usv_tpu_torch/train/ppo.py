"""PPO learner (clipped surrogate, GAE) on the env batch — port of
``usv_tpu/train/ppo.py``.

Capability match for the reference's ``config_ppo`` path
(``train_test/config.py:3-15``): n_steps=2048 rollout horizon, minibatch 64,
pi/vf nets 256x256, log_std_init=-2, and gSDE (use_sde + sde_sample_freq=4,
config.py:4-5): exploration noise is state-dependent (phi(s) @ sigma E) with
the exploration matrix resampled every sde_sample_freq env steps.

One iteration {rollout -> GAE -> epochs of minibatch updates} is a Python
loop of eager tensor ops on the learner's device. The train state is a
mutable object the methods update in place. Where JAX splits a key, the
collect and iteration functions take an optional ``draws`` argument holding
the draws themselves; the default draws come from the run's one
``torch.Generator``. The truncation bootstrap evaluates the value net on the
terminal frames at every step and masks it with JAX's own arithmetic
(``reward + gamma * V * truncated_only``), where JAX skips the forward with a
``lax.cond`` when no env truncated: the host never reads the mask back.

A seed population (``init_many``, ``train_iteration_many``,
``eval_policy_stats_many``: the ``--recipe robust`` path) runs S learners as
one program, as ``SacLearner``'s does: the S x num_envs envs are the rows of
one ``BatchedEnv``, the actor-critic a ``Stacked`` set of S members called
through one ``vmap``, one Adam over the stacked parameters, one backward
pass on the sum of the members' losses, and the gradient clipped by each
member's own global norm. Member ``i`` draws from its own generator what the
single-seed learner with its seed draws, so member ``i`` is that learner.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from usv_tpu_torch.envs.registry import EnvHandle
from usv_tpu_torch.envs.types import tree_map
from usv_tpu_torch.models.mlp import PpoActorCritic
from usv_tpu_torch.models.sde import SdeState, init_sde, maybe_resample
from usv_tpu_torch.models.stacked import Stacked, vmap_members
from usv_tpu_torch.parallel.mesh import EnvMesh, per_shard, unshard_env_batch
from usv_tpu_torch.train.common import (
    adam,
    clip_by_global_norm,
    clip_by_global_norm_many,
    derived_seed,
    eval_stats,
    eval_stats_many,
    global_norm,
    linear_schedule,
    new_generator,
    per_member,
    seeded_init,
    step_with,
    take_adam,
    take_rows,
)
from usv_tpu_torch.vector.batch import BatchedEnv, BatchState

EVAL_TAG = 7  # JAX's fold_in(ts.key, 7)


@dataclasses.dataclass(frozen=True)
class PpoConfig:
    n_steps: int = 2048          # config.py:7 (per env)
    batch_size: int = 64         # config.py:8
    n_epochs: int = 10           # SB3 default
    learning_rate: float = 3e-4  # SB3 default (config comments one out)
    # optional linear lr decay over the first lr_decay_updates GRADIENT
    # updates (to lr * lr_final_fraction, held constant after)
    lr_decay_updates: Optional[int] = None
    lr_final_fraction: float = 0.0
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    pi_hidden: Tuple[int, int] = (256, 256)
    vf_hidden: Tuple[int, int] = (256, 256)
    log_std_init: float = -2.0   # config.py:12
    use_sde: bool = True         # config.py:4
    sde_sample_freq: int = 4     # config.py:5
    num_envs: int = 16
    frame_stack: int = 5
    # bfloat16 MLP trunks (parameters and optimizer state stay float32)
    compute_dtype: str = "float32"
    # fold k consecutive minibatches into ONE optimizer step on a
    # k*batch_size batch: same data per epoch, 1/k the optimizer steps
    update_fusion: int = 1
    # False keeps ONE shuffle per iteration (epochs revisit the same
    # minibatches) instead of SB3's fresh permutation every epoch
    reshuffle_epochs: bool = True
    # S > 1 permutes within S env-contiguous row groups and builds every
    # minibatch from eff_batch/S rows of EACH group (stratified); 0/1 =
    # global shuffle. Requires num_envs % S == 0 and batch_size*fusion % S == 0.
    shuffle_groups: int = 0
    # with shuffle_groups > 1: permute the per-env carried state (env state,
    # frame stack, sde) across the env axis between iterations, so group
    # membership rotates
    shuffle_group_rotate: bool = False
    # numerical guard (utils/guards.py): diverged envs terminate with reward
    # 0 and auto-reset instead of poisoning the on-policy batch
    sanitize_envs: bool = True
    # store the flattened rollout OBSERVATIONS in bfloat16 for the update
    # phase (actions, log-probs, advantages and returns stay float32)
    rollout_obs_bf16: bool = False


def group_permutations(generator: Optional[torch.Generator], n_groups: int, n_local: int,
                       device) -> torch.Tensor:
    """``(n_groups, n_local)``: one independent permutation per group."""
    return torch.stack([torch.randperm(n_local, generator=generator, device=device)
                        for _ in range(n_groups)])


def apply_grouped_minibatches(tree: dict, n_groups: int, eff_batch: int, perms: torch.Tensor):
    """Stratified minibatching with the given group-local permutations (JAX's
    ``grouped_minibatches`` takes a key; here :func:`group_permutations`
    draws, this function applies, so that a test can feed JAX's draws).

    ``tree`` values are rollout tensors of shape ``(n_steps, num_envs, *f)``.
    Rows are regrouped env-major into ``n_groups`` env-contiguous groups,
    permuted WITHIN each group by ``perms`` (``(n_groups, n_local)``), and
    every minibatch takes ``eff_batch / n_groups`` rows from EACH group,
    returned as tensors of shape ``(n_batches, eff_batch, *f)`` with group
    g's rows contiguous at ``[g*eff_local, (g+1)*eff_local)``."""
    n_steps, num_envs = next(iter(tree.values())).shape[:2]
    if num_envs % n_groups or eff_batch % n_groups:
        raise ValueError(
            f"shuffle_groups ({n_groups}) must divide num_envs "
            f"({num_envs}) and batch_size*update_fusion ({eff_batch})"
        )
    n_local = n_steps * num_envs // n_groups
    eff_local = eff_batch // n_groups
    n_batches = n_steps * num_envs // eff_batch
    groups = torch.arange(n_groups, device=perms.device)[:, None]

    def pick(x):
        f = x.shape[2:]
        x = x.transpose(0, 1).reshape(n_groups, n_local, *f)  # env-major: whole trajectories
        mb = x[groups, perms][:, : n_batches * eff_local].reshape(n_groups, n_batches, eff_local, *f)
        return mb.transpose(0, 1).reshape(n_batches, eff_batch, *f)

    return {k: pick(v) for k, v in tree.items()}


@dataclasses.dataclass
class PpoTrainState:
    model: PpoActorCritic
    opt: torch.optim.Adam
    batch: BatchState               # env state and the (B, S, obs_dim) frame stack
    generator: torch.Generator      # the training stream
    seed: int
    update_count: int = 0           # iterations done
    opt_steps: int = 0              # optimizer steps done (the lr schedule's count)
    sde: Optional[SdeState] = None  # when cfg.use_sde
    mesh: Optional[EnvMesh] = None  # set by shard_ppo_train_state


@dataclasses.dataclass
class PpoPopulationState:
    """S independent learners as one state: the actor-critic a
    :class:`Stacked` of S members, the env rows member-major (member ``i``'s
    envs are rows ``[i*B, (i+1)*B)``), one generator per member; the counters
    are shared."""
    model: Stacked
    opt: torch.optim.Adam
    batch: BatchState                # S * num_envs rows
    generators: List[torch.Generator]
    seeds: List[int]
    update_count: int = 0
    opt_steps: int = 0
    sde: Optional[SdeState] = None   # (S * num_envs, ...) when cfg.use_sde


class PpoLearner:
    def __init__(self, handle: EnvHandle, config: PpoConfig = PpoConfig()):
        self.handle = handle
        self.cfg = config
        self.device = handle.device
        env_cfg = handle.cfg
        self.obs_dim = env_cfg.obs_dim * max(1, config.frame_stack)
        self.act_dim = env_cfg.action_dim
        self.compute_dtype = getattr(torch, config.compute_dtype)
        if config.lr_decay_updates:
            self.lr_at = linear_schedule(config.learning_rate,
                                         config.learning_rate * config.lr_final_fraction,
                                         config.lr_decay_updates)
        else:
            self.lr_at = lambda count: config.learning_rate
        self.benv = BatchedEnv(handle, config.num_envs, frame_stack=max(1, config.frame_stack),
                               sanitize=config.sanitize_envs)
        self._low = torch.tensor(env_cfg.action_low, dtype=torch.float32, device=self.device)
        self._high = torch.tensor(env_cfg.action_high, dtype=torch.float32, device=self.device)
        self._benv_many = {}  # population BatchedEnvs by member count

    def build_model(self) -> PpoActorCritic:
        """A fresh actor-critic of this learner's architecture and compute dtype."""
        cfg = self.cfg
        return PpoActorCritic(self.obs_dim, self.act_dim, pi_hidden=cfg.pi_hidden,
                              vf_hidden=cfg.vf_hidden, log_std_init=cfg.log_std_init,
                              use_sde=cfg.use_sde, compute_dtype=self.compute_dtype)

    def init(self, seed: int = 0) -> PpoTrainState:
        """The network initialized from ``seed`` (on the CPU, then moved: the
        same weights on every device) and fresh envs."""
        cfg = self.cfg
        with seeded_init(seed):
            model = self.build_model()
        model.to(self.device)
        generator = new_generator(seed, self.device)
        batch, _ = self.benv.reset(generator)
        sde = None
        if cfg.use_sde:
            sde = init_sde(generator, cfg.pi_hidden[-1], self.act_dim, (cfg.num_envs,), self.device)
        return PpoTrainState(model=model, opt=adam(model.parameters(), self.lr_at(0)), batch=batch,
                             generator=generator, seed=int(seed), sde=sde)

    # ------------------------------------------------------------- rollout

    @torch.no_grad()
    def _collect(self, ts: PpoTrainState, draws=None):
        """``n_steps`` steps of every env -> ``(ts, traj, last_value)``;
        ``traj`` maps obs, action, logp, value, reward (bootstrap-augmented,
        for GAE), raw_reward (the env's) and done to ``(n_steps, num_envs,
        ...)`` tensors (this process's envs on a rank).

        The action is clipped to the env's bounds before the step; the
        log-prob keeps the unclipped action, as SB3 does. ``draws``: one dict
        per step with ``resample`` (gSDE normals) or ``noise``, and ``reset``
        (the auto-reset's uniform block), at the global width; a rank keeps
        its envs' rows of every draw."""
        cfg, dev = self.cfg, self.device
        B = cfg.num_envs
        mesh = ts.mesh
        rows = mesh.local if mesh is not None else (lambda x: x)
        width = self.handle.n_uniform(self.handle.cfg)
        cols = {k: [] for k in ("obs", "action", "logp", "value", "reward", "raw_reward", "done")}
        for t in range(cfg.n_steps):
            d = draws[t] if draws is not None else {}
            frames = ts.batch.frames
            obs = frames.reshape(frames.shape[0], -1)
            if cfg.use_sde:
                normals = d.get("resample")
                if normals is None:
                    normals = torch.randn((B, *ts.sde.exploration_mat.shape[1:]),
                                          generator=ts.generator, device=dev)
                ts.sde = maybe_resample(ts.sde, None, cfg.sde_sample_freq, normals=rows(normals))
                action, logp, value = per_shard(mesh, ts.model.sample_sde, obs, ts.sde)
            else:
                noise = d.get("noise")
                if noise is None:
                    noise = torch.randn((B, self.act_dim), generator=ts.generator, device=dev)
                action, logp, value = per_shard(mesh, lambda o, n: ts.model.sample(o, noise=n),
                                                obs, rows(noise))
            clipped = torch.clamp(action, self._low, self._high)
            reset = d.get("reset")
            if reset is None:
                reset = torch.rand((B, width), generator=ts.generator, dtype=torch.float32, device=dev)
            ts.batch, step = self.benv.step(ts.batch, clipped, uniform=rows(reset))
            # time-limit bootstrap, SB3-style: a truncated (not terminated)
            # episode adds gamma * V(terminal obs), so that GAE can treat
            # every done as terminal
            truncated_only = (step.truncated & ~step.terminated).to(torch.float32)
            terminal = torch.cat([frames[:, 1:], step.info["terminal_observation"][:, None]], 1)
            terminal_value = per_shard(mesh, ts.model.value_only, terminal.reshape(obs.shape[0], -1))
            reward = step.reward + cfg.gamma * terminal_value * truncated_only
            for k, v in (("obs", obs), ("action", action), ("logp", logp), ("value", value),
                         ("reward", reward), ("raw_reward", step.reward),
                         ("done", step.done.to(torch.float32))):
                cols[k].append(v)
        last_value = per_shard(mesh, ts.model.value_only, ts.batch.frames.reshape(obs.shape[0], -1))
        return ts, {k: torch.stack(v) for k, v in cols.items()}, last_value

    @staticmethod
    def _gae(traj, last_value, gamma, lam):
        """A_t = delta_t + gamma*lam*(1-d_t)*A_{t+1},
        delta_t = r_t + gamma*(1-d_t)*V_{t+1} - V_t — the bootstrap of step t
        is masked by step t's OWN done (d_t == s_{t+1} is terminal)."""
        advs = []
        adv_next, v_next = torch.zeros_like(last_value), last_value
        for t in reversed(range(traj["reward"].shape[0])):
            nonterm = 1.0 - traj["done"][t]
            delta = traj["reward"][t] + gamma * v_next * nonterm - traj["value"][t]
            adv_next = delta + gamma * lam * nonterm * adv_next
            v_next = traj["value"][t]
            advs.append(adv_next)
        advs = torch.stack(advs[::-1])
        return advs, advs + traj["value"]

    # -------------------------------------------------------------- update

    def _loss(self, model: PpoActorCritic, batch, clip_range, ent_coef, vf_coef,
              total: Optional[int] = None, mesh: Optional[EnvMesh] = None):
        """The clipped surrogate, the value loss and the entropy bonus. With
        ``total`` (on ranks: the minibatch's global row count) this process's
        rows give their share of the global means, and the advantage is
        normalised by the minibatch's global mean and population std, summed
        over the ranks in two passes."""
        logp, entropy, value = model.log_prob(batch["obs"], batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        if total is None:
            # the population standard deviation, as jnp.std (torch's default is ddof 1)
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)

            def mean(x):
                return x.mean()
        else:
            mu = mesh.all_sum([adv.sum()])[0] / total
            var = mesh.all_sum([torch.square(adv - mu).sum()])[0] / total
            adv = (adv - mu) / (torch.sqrt(var) + 1e-8)

            def mean(x):
                return x.sum() / total
        pg1 = adv * ratio
        pg2 = adv * torch.clamp(ratio, 1.0 - clip_range, 1.0 + clip_range)
        pg_loss = -mean(torch.minimum(pg1, pg2))
        v_loss = mean(torch.square(value - batch["ret"]))
        ent_loss = -mean(entropy)
        return pg_loss + vf_coef * v_loss + ent_coef * ent_loss

    def _minibatch_step(self, ts: PpoTrainState, batch, total: Optional[int] = None) -> None:
        """One optimizer step: gradients (summed over the ranks), optax's clip
        by global norm, Adam at the schedule's learning rate."""
        cfg = self.cfg
        params = list(ts.model.parameters())
        loss = self._loss(ts.model, batch, cfg.clip_range, cfg.ent_coef, cfg.vf_coef, total, ts.mesh)
        grads = torch.autograd.grad(loss, params)
        if total is not None:
            grads = ts.mesh.all_sum(grads)
        grads = clip_by_global_norm(grads, cfg.max_grad_norm)
        step_with(ts.opt, params, grads, self.lr_at(ts.opt_steps))
        ts.opt_steps += 1

    def _minibatches(self, traj, advs, returns, mesh: Optional[EnvMesh] = None):
        """-> ``(draw, batches, n_batches)``: ``draw(generator)`` makes one
        shuffle's permutations; ``batches(perms)`` lays the rollout out as
        ``(n_batches, eff_batch, ...)`` tensors under them.

        On ranks ``batches(perms)`` is a list of ``n_batches`` dicts: this
        rank's rows of each global minibatch (row ``t*B + b`` of the rollout
        belongs to the rank holding env ``b``), found in one read-back per
        shuffle. No rollout row moves between ranks."""
        cfg = self.cfg
        T = traj["obs"].shape[0]
        B = cfg.num_envs
        n_total = cfg.n_steps * B
        obs_dtype = torch.bfloat16 if cfg.rollout_obs_bf16 else torch.float32
        eff_batch = cfg.batch_size * max(1, cfg.update_fusion)
        n_batches = n_total // eff_batch
        rollout = dict(obs=traj["obs"].to(obs_dtype), action=traj["action"], logp=traj["logp"],
                       adv=advs, ret=returns)
        ranks = mesh is not None and not mesh.logical
        if cfg.shuffle_groups > 1:
            def draw(generator):
                return group_permutations(generator, cfg.shuffle_groups,
                                          n_total // cfg.shuffle_groups, self.device)

            def layout(tree, perms):
                return apply_grouped_minibatches(tree, cfg.shuffle_groups, eff_batch, perms)
        else:
            def draw(generator):
                return torch.randperm(n_total, generator=generator, device=self.device)

            def layout(tree, perm):
                keep = perm[: n_batches * eff_batch]
                return {k: v.reshape(n_total, *v.shape[2:]).index_select(0, keep)
                        .reshape(n_batches, eff_batch, *v.shape[2:]) for k, v in tree.items()}
        if not ranks:
            return draw, lambda perms: layout(rollout, perms), n_batches

        flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in rollout.items()}
        lo, hi = mesh.bounds(B)
        ids = torch.arange(n_total, device=self.device).reshape(T, B)

        def batches(perms):
            g = layout({"id": ids}, perms)["id"]  # (n_batches, eff_batch) global rollout rows
            env = g % B
            mine = (env >= lo) & (env < hi)
            counts = mine.sum(1).tolist()  # waits for the device
            local = ((g // B) * (hi - lo) + env - lo)[mine]
            parts = torch.split(local, counts)
            return [{k: v.index_select(0, rows) for k, v in flat.items()} for rows in parts]

        return draw, batches, n_batches

    def _update(self, ts: PpoTrainState, traj, last_value, draws=None):
        """GAE, then ``n_epochs`` sweeps of minibatch steps. ``draws``: a
        dict with ``perms`` (one permutation, or one ``(S, n_local)`` stack
        of group permutations, per shuffle: per epoch with
        ``reshuffle_epochs``, else one) and ``rotate`` (the env permutation
        of the group rotation)."""
        cfg = self.cfg
        mesh = ts.mesh
        ranks = mesh is not None and not mesh.logical
        advs, returns = self._gae(traj, last_value, cfg.gamma, cfg.gae_lambda)
        draw, batches, n_batches = self._minibatches(traj, advs, returns, mesh)
        total = cfg.batch_size * max(1, cfg.update_fusion) if ranks else None
        perms = iter(draws["perms"]) if draws is not None else None

        def next_batches():
            return batches(next(perms) if perms is not None else draw(ts.generator))

        layout = None if cfg.reshuffle_epochs else next_batches()
        for _ in range(cfg.n_epochs):
            # SB3 semantics with reshuffle_epochs: a fresh permutation per epoch
            epoch = next_batches() if cfg.reshuffle_epochs else layout
            for i in range(n_batches):
                batch = epoch[i] if ranks else {k: v[i] for k, v in epoch.items()}
                self._minibatch_step(ts, batch, total)
        ts.update_count += 1
        if cfg.shuffle_groups > 1 and cfg.shuffle_group_rotate:
            # group-membership rotation: permute the per-env carried state
            # between iterations, so the next rollout's env-contiguous groups
            # hold a fresh random subset of trajectories (on ranks the state
            # is assembled once, permuted, and each rank keeps its rows)
            perm = draws["rotate"] if draws is not None else torch.randperm(
                cfg.num_envs, generator=ts.generator, device=self.device)

            def pick(tree):
                if tree is None:
                    return None
                if ranks:
                    tree = unshard_env_batch(tree, mesh)
                return tree_map(lambda x: rows(x.index_select(0, perm)), tree)

            rows = mesh.local if ranks else (lambda x: x)
            ts.batch = pick(ts.batch)
            ts.sde = pick(ts.sde)
        return ts

    def train_iteration(self, ts: PpoTrainState, draws=None):
        """One {rollout, GAE, epochs x minibatches} cycle. ``draws``: a dict
        with ``collect`` (:meth:`_collect`'s list) and :meth:`_update`'s
        ``perms`` and ``rotate``. Returns ``(ts, mean env reward)``, the mean
        a 0-d device tensor over all envs (over the ranks' envs on ranks)."""
        ts, traj, last_value = self._collect(ts, None if draws is None else draws["collect"])
        ts = self._update(ts, traj, last_value, draws)
        reward = traj["raw_reward"]
        if ts.mesh is None or ts.mesh.logical:
            return ts, reward.mean()
        return ts, ts.mesh.all_sum([reward.sum()])[0] / (self.cfg.n_steps * self.cfg.num_envs)

    # --------------------------------------------------------------- eval

    def eval_seed(self, ts: PpoTrainState) -> int:
        """The seed of the eval at this point of the run (from the run's seed
        and counters; nothing is drawn)."""
        return derived_seed(ts.seed, ts.update_count, ts.opt_steps, EVAL_TAG)

    def eval_policy(self, ts: PpoTrainState, n_steps: int = 500, num_envs: int = 16) -> float:
        """Deterministic-policy rollout (clipped mean action) on fresh envs;
        returns mean reward per step — the same protocol as
        ``SacLearner.eval_policy``, so SAC/PPO numbers are comparable."""
        return self.eval_policy_stats(ts, n_steps, num_envs)["reward_per_step"]

    def eval_policy_stats(self, ts: PpoTrainState, n_steps: int = 500, num_envs: int = 16) -> dict:
        """Deterministic eval with outcome counts (see
        ``SacLearner.eval_policy_stats``)."""
        return self.eval_policy_stats_at(ts.model, self.eval_seed(ts), n_steps, num_envs)

    def eval_policy_stats_at(self, model: PpoActorCritic, seed: int, n_steps: int = 500,
                             num_envs: int = 16) -> dict:
        """The exact :meth:`eval_policy_stats` program for any actor-critic
        under an explicit seed (see ``SacLearner.eval_policy_stats_at``)."""
        benv = BatchedEnv(self.handle, num_envs, frame_stack=max(1, self.cfg.frame_stack),
                          sanitize=self.cfg.sanitize_envs)

        def act(obs):
            return torch.clamp(model.pi_mean(model.pi_trunk(obs)), self._low, self._high)

        return eval_stats(benv, seed, act, n_steps)

    # ---------------------------------------------------------- diagnostics

    def watch(self, ts: PpoTrainState) -> dict:
        """Parameter diagnostics — the analog of the reference's
        ``wandb.watch`` parameter logging (wandb_callback.py:126-131): global
        L2 norm of the actor-critic parameters and the mean exploration
        log-std. One read-back."""
        with torch.no_grad():
            values = torch.stack([global_norm(list(ts.model.parameters())),
                                  ts.model.log_std.mean()]).tolist()
        return dict(param_norm=values[0], log_std_mean=values[1])

    # ------------------------------------------------------- seed population

    def population_env(self, members: int) -> BatchedEnv:
        """The ``BatchedEnv`` of a population of ``members``: their
        ``members * num_envs`` envs as one batch."""
        if members not in self._benv_many:
            self._benv_many[members] = BatchedEnv(
                self.handle, members * self.cfg.num_envs, frame_stack=max(1, self.cfg.frame_stack),
                sanitize=self.cfg.sanitize_envs)
        return self._benv_many[members]

    def init_many(self, seeds: Sequence[int]) -> PpoPopulationState:
        """A population of independent learners, one per seed: member ``i``
        starts as :meth:`init` ``(seeds[i])`` starts."""
        cfg, dev, B = self.cfg, self.device, self.cfg.num_envs
        seeds = [int(s) for s in seeds]
        models, generators, uniforms, mats = [], [], [], []
        width = self.handle.n_uniform(self.handle.cfg)
        for seed in seeds:
            with seeded_init(seed):
                models.append(self.build_model().to(dev))
            g = new_generator(seed, dev)
            generators.append(g)
            uniforms.append(torch.rand((B, width), generator=g, dtype=torch.float32, device=dev))
            if cfg.use_sde:
                mats.append(init_sde(g, cfg.pi_hidden[-1], self.act_dim, (B,), dev).exploration_mat)
        model = Stacked.from_modules(models)
        batch, _ = self.population_env(len(seeds)).reset(uniform=torch.cat(uniforms))
        sde = None
        if cfg.use_sde:
            mat = torch.cat(mats)
            sde = SdeState(exploration_mat=mat, step=torch.zeros(mat.shape[0], dtype=torch.int32,
                                                                 device=dev))
        return PpoPopulationState(model=model, opt=adam(model.params, self.lr_at(0)), batch=batch,
                                  generators=generators, seeds=seeds, sde=sde)

    def _value_many(self, ps: PpoPopulationState, obs):
        S = len(ps.seeds)
        return vmap_members(lambda model, o: model.value_only(o), [ps.model],
                            obs.view(S, -1, obs.shape[-1])).reshape(-1)

    @torch.no_grad()
    def _collect_many(self, ps: PpoPopulationState):
        """:meth:`_collect` for every member at once -> ``(ps, traj,
        last_value)`` with ``(n_steps, S * num_envs, ...)`` columns; each
        member's draws from its own generator in the single learner's order."""
        cfg, dev, B = self.cfg, self.device, self.cfg.num_envs
        S = len(ps.seeds)
        benv = self.population_env(S)
        width = self.handle.n_uniform(self.handle.cfg)
        cols = {k: [] for k in ("obs", "action", "logp", "value", "reward", "raw_reward", "done")}
        for _ in range(cfg.n_steps):
            frames = ps.batch.frames
            obs = frames.reshape(S * B, -1)
            if cfg.use_sde:
                normals = per_member(ps.generators, lambda g: torch.randn(
                    (B, *ps.sde.exploration_mat.shape[1:]), generator=g, device=dev))
                ps.sde = maybe_resample(ps.sde, None, cfg.sde_sample_freq, normals=normals)
                mat = ps.sde.exploration_mat
                out = vmap_members(
                    lambda model, o, m, k: model.sample_sde(o, SdeState(exploration_mat=m, step=k)),
                    [ps.model], obs.view(S, B, -1), mat.view(S, B, *mat.shape[1:]),
                    ps.sde.step.view(S, B))
            else:
                noise = per_member(ps.generators, lambda g: torch.randn((B, self.act_dim),
                                                                        generator=g, device=dev))
                out = vmap_members(lambda model, o, n: model.sample(o, noise=n), [ps.model],
                                   obs.view(S, B, -1), noise.view(S, B, -1))
            action, logp, value = (x.reshape(S * B, *x.shape[2:]) for x in out)
            clipped = torch.clamp(action, self._low, self._high)
            reset = per_member(ps.generators, lambda g: torch.rand(
                (B, width), generator=g, dtype=torch.float32, device=dev))
            ps.batch, step = benv.step(ps.batch, clipped, uniform=reset)
            truncated_only = (step.truncated & ~step.terminated).to(torch.float32)
            terminal = torch.cat([frames[:, 1:], step.info["terminal_observation"][:, None]], 1)
            terminal_value = self._value_many(ps, terminal.reshape(S * B, -1))
            reward = step.reward + cfg.gamma * terminal_value * truncated_only
            for k, v in (("obs", obs), ("action", action), ("logp", logp), ("value", value),
                         ("reward", reward), ("raw_reward", step.reward),
                         ("done", step.done.to(torch.float32))):
                cols[k].append(v)
        last_value = self._value_many(ps, ps.batch.frames.reshape(S * B, -1))
        return ps, {k: torch.stack(v) for k, v in cols.items()}, last_value

    def _minibatches_many(self, ps: PpoPopulationState, traj, advs, returns):
        """:meth:`_minibatches` per member -> ``(draw, batches, n_batches)``:
        ``draw()`` makes every member's permutations from its own generator,
        ``batches(perms)`` lays each member's rollout out under its own
        permutation as ``(S, n_batches, eff_batch, ...)`` tensors."""
        cfg = self.cfg
        S, B, T = len(ps.seeds), cfg.num_envs, cfg.n_steps
        n_total = T * B
        obs_dtype = torch.bfloat16 if cfg.rollout_obs_bf16 else torch.float32
        eff_batch = cfg.batch_size * max(1, cfg.update_fusion)
        n_batches = n_total // eff_batch

        def per_member_rollout(x):  # (T, S*B, ...) -> (S, T, B, ...)
            return x.reshape(T, S, B, *x.shape[2:]).transpose(0, 1)

        rollout = dict(obs=traj["obs"].to(obs_dtype), action=traj["action"], logp=traj["logp"],
                       adv=advs, ret=returns)
        rollout = {k: per_member_rollout(v) for k, v in rollout.items()}
        if cfg.shuffle_groups > 1:
            def draw():
                return torch.stack([group_permutations(g, cfg.shuffle_groups,
                                                       n_total // cfg.shuffle_groups, self.device)
                                    for g in ps.generators])

            def batches(perms):
                return torch.func.vmap(lambda tree, perm: apply_grouped_minibatches(
                    tree, cfg.shuffle_groups, eff_batch, perm))(rollout, perms)
        else:
            flat = {k: v.reshape(S, n_total, *v.shape[3:]) for k, v in rollout.items()}
            members = torch.arange(S, device=self.device)[:, None]

            def draw():
                return torch.stack([torch.randperm(n_total, generator=g, device=self.device)
                                    for g in ps.generators])

            def batches(perms):
                keep = perms[:, : n_batches * eff_batch]
                return {k: v[members, keep].reshape(S, n_batches, eff_batch, *v.shape[2:])
                        for k, v in flat.items()}
        return draw, batches, n_batches

    def _loss_many(self, ps: PpoPopulationState, batch):
        """Every member's :meth:`_loss` on its own minibatch (``(S, eff_batch,
        ...)`` tensors) through one ``vmap``: ``(S,)``."""
        cfg = self.cfg
        return vmap_members(lambda model, b: self._loss(model, b, cfg.clip_range, cfg.ent_coef,
                                                        cfg.vf_coef), [ps.model], batch)

    def _minibatch_step_many(self, ps: PpoPopulationState, batch) -> None:
        """:meth:`_minibatch_step` for every member: one backward pass on the
        sum of the members' losses, each member's gradient clipped by its own
        global norm, one Adam step."""
        cfg = self.cfg
        grads = clip_by_global_norm_many(
            torch.autograd.grad(self._loss_many(ps, batch).sum(), ps.model.params), cfg.max_grad_norm)
        step_with(ps.opt, ps.model.params, grads, self.lr_at(ps.opt_steps))
        ps.opt_steps += 1

    def _update_many(self, ps: PpoPopulationState, traj, last_value):
        """:meth:`_update` for every member: GAE, the epochs of minibatch
        steps under each member's own shuffles, the group rotation."""
        cfg = self.cfg
        advs, returns = self._gae(traj, last_value, cfg.gamma, cfg.gae_lambda)
        draw, batches, n_batches = self._minibatches_many(ps, traj, advs, returns)
        layout = None if cfg.reshuffle_epochs else batches(draw())
        for _ in range(cfg.n_epochs):
            epoch = batches(draw()) if cfg.reshuffle_epochs else layout
            for i in range(n_batches):
                self._minibatch_step_many(ps, {k: v[:, i] for k, v in epoch.items()})
        ps.update_count += 1
        if cfg.shuffle_groups > 1 and cfg.shuffle_group_rotate:
            B = cfg.num_envs
            perm = per_member(ps.generators, lambda g: torch.randperm(B, generator=g,
                                                                      device=self.device))
            rows = perm + torch.arange(len(ps.seeds), device=self.device).repeat_interleave(B) * B
            ps.batch = tree_map(lambda x: x.index_select(0, rows), ps.batch)
            ps.sde = tree_map(lambda x: x.index_select(0, rows), ps.sde)
        return ps

    def train_iteration_many(self, ps: PpoPopulationState):
        """:meth:`train_iteration` for the population. Returns ``(ps, (S,)
        mean env rewards)``."""
        ps, traj, last_value = self._collect_many(ps)
        ps = self._update_many(ps, traj, last_value)
        S = len(ps.seeds)
        return ps, traj["raw_reward"].view(self.cfg.n_steps, S, -1).mean((0, 2))

    def take_members(self, ps: PpoPopulationState, keep: Sequence[int]) -> PpoPopulationState:
        """The population of the members ``keep`` (the racing cull): their
        parameters, Adam moments, env rows, frames, gSDE state and
        generators, as they were."""
        idx = torch.as_tensor(list(keep), dtype=torch.long, device=self.device)
        model = ps.model.take(idx)
        B = self.cfg.num_envs
        return PpoPopulationState(
            model=model, opt=take_adam(ps.opt, ps.model.params, model.params, idx),
            batch=take_rows(ps.batch, idx, B), generators=[ps.generators[i] for i in keep],
            seeds=[ps.seeds[i] for i in keep], update_count=ps.update_count,
            opt_steps=ps.opt_steps, sde=take_rows(ps.sde, idx, B))

    def module_from(self, params: dict) -> PpoActorCritic:
        """An ordinary actor-critic on the learner's device holding
        ``params`` (a member's :meth:`Stacked.member`)."""
        model = self.build_model()
        model.load_state_dict(params)
        return model.to(self.device)

    def eval_seeds(self, ps: PpoPopulationState) -> List[int]:
        """Each member's :meth:`eval_seed` at this point of the run."""
        return [derived_seed(seed, ps.update_count, ps.opt_steps, EVAL_TAG) for seed in ps.seeds]

    def eval_policy_many(self, ps: PpoPopulationState, n_steps: int = 500, num_envs: int = 16):
        """Per-member deterministic eval -> ``(S,)`` mean reward per step."""
        return self.eval_policy_stats_many(ps, n_steps, num_envs)["reward_per_step"]

    def eval_policy_stats_many(self, ps: PpoPopulationState, n_steps: int = 500,
                               num_envs: int = 16) -> dict:
        """:meth:`eval_policy_stats` of every member in one batch of
        ``S * num_envs`` envs, member ``i``'s from its own eval seed: a dict
        of ``(S,)`` float arrays."""
        S = len(ps.seeds)
        benv = BatchedEnv(self.handle, S * num_envs, frame_stack=max(1, self.cfg.frame_stack),
                          sanitize=self.cfg.sanitize_envs)
        low, high = self._low, self._high

        def act(obs):
            return vmap_members(lambda model, o: torch.clamp(model.pi_mean(model.pi_trunk(o)), low, high),
                                [ps.model], obs.view(S, num_envs, -1)).reshape(S * num_envs, -1)

        return eval_stats_many(benv, self.eval_seeds(ps), act, n_steps)

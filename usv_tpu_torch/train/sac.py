"""SAC learner with CAPS action-smoothness regularization — port of
``usv_tpu/train/sac.py``.

Re-implements the training capability of the reference's patched SB3 SAC
(``train_test/config.py:17-37``): twin critics, auto-tuned entropy
temperature, soft target updates, ``train_freq = gradient_steps = 8``,
400x300 nets, lr 1e-4, buffer 400k, batch 256, learning_starts 50k — plus the
CAPS smoothness terms implied by ``lambda_t/lambda_s/eps_s`` (config.py:34-36;
CAPS = "Regularizing Action Policies for Smooth Control", Mysore et al.):

    L_T = lambda_t * E ||pi(s_t) - pi(s_{t+1})||^2        (temporal)
    L_S = lambda_s * E ||pi(s) - pi(s~)||^2, s~ ~ N(s, eps_s)  (spatial)

Against the JAX learner: one {collect ``train_freq`` env steps -> insert ->
``gradient_steps`` updates} round is a Python loop of eager tensor ops on the
learner's device (the card unless the env handle names another); envs, replay
buffer and networks stay there. The train state is a mutable object that the
methods update in place and return. JAX's ``lax.cond``s are host decisions on
host counters (the warm-up phase, the update gate on the buffer's fill), so
nothing is read back from the device. Gradients come from autograd
(``torch.autograd.grad`` on the network being stepped, so no gradient reaches
another), optimizers from ``torch.optim.Adam`` with optax's constants.

A seed population (``init_many``, ``train_rounds_many``,
``eval_policy_stats_many``: the ``--recipe robust`` path) runs S learners as
ONE program: the S x num_envs envs are the rows of one ``BatchedEnv``, each
network is a :class:`~usv_tpu_torch.models.stacked.Stacked` set of S
members called through one ``vmap``, each replay buffer a member block of
one set of tensors, one Adam steps every member's parameters, and one
backward pass on the sum of the members' losses gives every member its own
gradient. So a population step issues the aten calls of one step whatever
S is; only the draws grow with S, because member ``i`` draws from its own
generator, seeded ``seeds[i]``, exactly what the single-seed learner with
that seed draws: member ``i`` is that learner.

Data parallelism (``usv_tpu_torch/parallel``): a state sharded over a mesh
(``shard_sac_train_state``) trains through the same calls. Every draw of a
collect step (the gSDE normals, the warm-up actions, the actor's noise, the
auto-reset's uniform block) is drawn at the GLOBAL width from the replicated
generator, and a rank keeps its envs' rows, so rank ``k``'s envs see exactly
what the one-process run gives envs ``[k*B/n, (k+1)*B/n)``. A rank's losses
are its rows' share of the global means (sums over ``batch_size``), and its
gradients are summed over the ranks before Adam. With shard-local replay
(``cfg.shard_local_replay``, the learner given the mesh) each shard inserts
and samples its own capacity block; in global mode every rank draws the
one-process run's replay indices and evaluates the rows it owns.

Randomness: one ``torch.Generator`` per run on the learner's device feeds the
resets, the warm-up actions, the gSDE matrices, the replay indices and the
update noise. Where the JAX learner splits a key, the collect and update
functions take an optional ``draws`` argument holding the draws themselves,
so that a test hands both sides the same numbers. Eval and ``watch`` draw
from generators seeded by :func:`~usv_tpu_torch.train.common.derived_seed`
(the run's seed and counters), never from the training stream: a run that
evaluates trains exactly as one that does not.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
import types
from typing import List, Optional, Sequence, Tuple

import torch

from usv_tpu_torch.envs.registry import EnvHandle
from usv_tpu_torch.envs.types import reset_uniform
from usv_tpu_torch.models.mlp import DoubleCritic, SquashedGaussianActor
from usv_tpu_torch.models.sde import SdeState, init_sde, maybe_resample
from usv_tpu_torch.models.stacked import Stacked, vmap_members
from usv_tpu_torch.parallel.mesh import EnvMesh, per_shard
from usv_tpu_torch.train.buffer import (
    ReplayBuffer,
    buffer_add_batch,
    buffer_add_many,
    buffer_add_traj_local,
    buffer_init,
    buffer_init_many,
    buffer_sample,
    buffer_sample_local,
    buffer_sample_many,
)
from usv_tpu_torch.train.common import (
    adam,
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
from usv_tpu_torch.timing import span
from usv_tpu_torch.vector.batch import BatchedEnv, BatchState

EVAL_TAG, WATCH_TAG = 7, 13  # JAX's fold_in(ts.key, 7) and fold_in(ts.key, 13)
SAMPLE_TAG = 17  # the shard-local replay draws of an update


@dataclasses.dataclass(frozen=True)
class SacConfig:
    # SB3-matching hyperparameters (train_test/config.py:17-37)
    buffer_size: int = 400_000
    batch_size: int = 256
    learning_rate: float = 1e-4
    # optional linear lr decay over the first lr_decay_steps GRADIENT steps
    # (to lr * lr_final_fraction, held constant after); the reference uses a
    # constant lr (config.py:23)
    lr_decay_steps: Optional[int] = None
    lr_final_fraction: float = 0.1
    gamma: float = 0.99
    tau: float = 0.005          # SB3 default (config passes none)
    train_freq: int = 8
    gradient_steps: int = 8
    learning_starts: int = 50_000
    hidden: Tuple[int, int] = (400, 300)
    log_std_init: float = -3.0
    # CAPS smoothness (config.py:34-36)
    lambda_t: float = 10.0
    lambda_s: float = 5.0
    eps_s: float = 0.1
    # gSDE exploration (config.py:18-19; SB3 use_sde + sde_sample_freq):
    # updates use the exact marginal distribution, collection noise is
    # temporally smooth via exploration matrices
    use_sde: bool = True
    sde_sample_freq: int = 4
    # vector-env setup
    num_envs: int = 64
    frame_stack: int = 5        # FrameStack(5), sb3_train.py:51
    # compute_dtype="bfloat16" runs the MLP trunks in bfloat16 (parameters
    # and Adam state stay float32). update_fusion=k folds k of the
    # gradient_steps sequential updates into one update on a k*batch_size
    # batch; fused_updates=True is full fusion (k = gradient_steps).
    compute_dtype: str = "float32"
    fused_updates: bool = False
    update_fusion: int = 1
    # shard-local replay: insert and sample the replay per mesh shard, so that
    # the gradient sums are the only steady-state collectives. Needs the
    # learner's mesh; num_envs, batch_size and the capacity must divide it.
    # Sampling is stratified-uniform (batch_size/n rows a shard).
    shard_local_replay: bool = False
    # action bounds; None derives them from the env config
    action_low: Optional[Tuple[float, ...]] = None
    action_high: Optional[Tuple[float, ...]] = None
    # numerical guard (utils/guards.py): diverged envs terminate (reward 0,
    # sanitized obs) and auto-reset; info["diverged"] counts them
    sanitize_envs: bool = True


@dataclasses.dataclass
class SacTrainState:
    actor: SquashedGaussianActor
    critic: DoubleCritic
    target_critic: DoubleCritic
    log_alpha: torch.Tensor         # () float32, optimized in place
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    alpha_opt: torch.optim.Adam
    buffer: ReplayBuffer
    batch: BatchState               # env state and the (B, S, obs_dim) frame stack
    generator: torch.Generator      # the training stream
    seed: int
    env_steps: int = 0              # collect steps taken (each by all num_envs envs)
    grad_steps: int = 0             # updates made
    sde: Optional[SdeState] = None  # when cfg.use_sde
    mesh: Optional[EnvMesh] = None  # set by shard_sac_train_state


@dataclasses.dataclass
class SacPopulationState:
    """S independent learners as one state: every network a :class:`Stacked`
    of S members, ``log_alpha`` ``(S,)``, the buffer ``(S, cap, ...)``, the
    env rows member-major (member ``i``'s envs are rows ``[i*B, (i+1)*B)``),
    and one generator per member. The counters are shared: every member
    takes every step."""
    actor: Stacked
    critic: Stacked
    target_critic: Stacked
    log_alpha: torch.Tensor          # (S,) float32, optimized in place
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    alpha_opt: torch.optim.Adam
    buffer: ReplayBuffer             # (S, cap, ...) tensors
    batch: BatchState                # S * num_envs rows
    generators: List[torch.Generator]
    seeds: List[int]
    env_steps: int = 0
    grad_steps: int = 0
    sde: Optional[SdeState] = None   # (S * num_envs, ...) when cfg.use_sde


class SacLearner:
    """Actor-learner bound to one env family on the handle's device."""

    def __init__(self, handle: EnvHandle, config: SacConfig = SacConfig(),
                 mesh: Optional[EnvMesh] = None):
        if config.shard_local_replay:
            if mesh is None:
                raise ValueError(
                    "shard_local_replay=True needs the device mesh: "
                    "SacLearner(handle, cfg, mesh=make_env_mesh())"
                )
            n = mesh.size
            if config.num_envs % n or config.batch_size % n:
                raise ValueError(
                    f"num_envs ({config.num_envs}) and batch_size "
                    f"({config.batch_size}) must divide the mesh size ({n})"
                )
        self.handle = handle
        self.cfg = config
        self.mesh = mesh
        self.device = handle.device
        env_cfg = handle.cfg
        self.obs_dim = env_cfg.obs_dim * max(1, config.frame_stack)
        self.act_dim = env_cfg.action_dim
        self.action_low = tuple(config.action_low if config.action_low is not None
                                else env_cfg.action_low)
        self.action_high = tuple(config.action_high if config.action_high is not None
                                 else env_cfg.action_high)
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.target_entropy = -float(self.act_dim)  # SB3 'auto'
        if config.lr_decay_steps:
            self.lr_at = linear_schedule(config.learning_rate,
                                         config.learning_rate * config.lr_final_fraction,
                                         config.lr_decay_steps)
        else:
            self.lr_at = lambda count: config.learning_rate

        self._fusion = config.gradient_steps if config.fused_updates else max(1, config.update_fusion)
        if config.gradient_steps % self._fusion:
            raise ValueError(f"update_fusion={self._fusion} must divide "
                             f"gradient_steps={config.gradient_steps}")
        # the replay capacity is a multiple of the per-round write block
        # (train_freq * num_envs rows): every insert is an aligned slice copy
        block = config.train_freq * config.num_envs
        self.buffer_capacity = -(-config.buffer_size // block) * block
        if self.buffer_capacity != config.buffer_size:
            warnings.warn(
                f"replay capacity rounded {config.buffer_size} -> "
                f"{self.buffer_capacity} (multiple of train_freq*num_envs="
                f"{block} for aligned writes). Checkpoints depend on the "
                "exact capacity — keep train_freq/num_envs fixed across "
                "save/resume, or set buffer_size to a multiple yourself."
            )
        self.benv = BatchedEnv(handle, config.num_envs, frame_stack=max(1, config.frame_stack),
                               sanitize=config.sanitize_envs)
        self._low = torch.tensor(self.action_low, dtype=torch.float32, device=self.device)
        self._high = torch.tensor(self.action_high, dtype=torch.float32, device=self.device)
        self._benv_many = {}  # population BatchedEnvs by member count

    # ------------------------------------------------------------------ init

    def build_actor(self) -> SquashedGaussianActor:
        """A fresh actor of this learner's architecture and compute dtype."""
        cfg = self.cfg
        return SquashedGaussianActor(
            self.obs_dim, self.act_dim, hidden=cfg.hidden, log_std_init=cfg.log_std_init,
            action_low=self.action_low, action_high=self.action_high, use_sde=cfg.use_sde,
            compute_dtype=self.compute_dtype)

    def init(self, seed: int = 0) -> SacTrainState:
        """Networks initialized from ``seed`` (on the CPU, then moved: the
        same weights on every device), fresh envs, an empty buffer."""
        cfg = self.cfg
        with seeded_init(seed):
            actor = self.build_actor()
            critic = DoubleCritic(self.obs_dim, self.act_dim, cfg.hidden,
                                  compute_dtype=self.compute_dtype)
        actor.to(self.device)
        critic.to(self.device)
        target = copy.deepcopy(critic).requires_grad_(False)
        generator = new_generator(seed, self.device)
        batch, _ = self.benv.reset(generator)
        sde = None
        if cfg.use_sde:
            sde = init_sde(generator, cfg.hidden[-1], self.act_dim, (cfg.num_envs,), self.device)
        log_alpha = torch.zeros((), device=self.device, requires_grad=True)
        lr = self.lr_at(0)
        return SacTrainState(
            actor=actor, critic=critic, target_critic=target, log_alpha=log_alpha,
            actor_opt=adam(actor.parameters(), lr), critic_opt=adam(critic.parameters(), lr),
            alpha_opt=adam([log_alpha], lr),
            buffer=buffer_init(self.buffer_capacity, self.obs_dim, self.act_dim, device=self.device,
                               blocks=self.mesh.size if cfg.shard_local_replay else 1),
            batch=batch, generator=generator, seed=int(seed), sde=sde,
        )

    # ----------------------------------------------------------- collection

    def mesh_of(self, ts: SacTrainState) -> Optional[EnvMesh]:
        """The mesh ``ts`` trains on: its own (a sharded state), else the
        learner's logical one (or none). A process-group mesh trains only a
        state sharded over it."""
        own = getattr(ts, "mesh", None)  # a population state has none
        if own is not None:
            if self.mesh is not None and self.mesh.size != own.size:
                raise ValueError(f"a state sharded over {own} on a learner of {self.mesh}")
            return own
        if self.mesh is not None and not self.mesh.logical:
            raise ValueError("a process-group mesh trains a sharded state: "
                             "shard_sac_train_state(learner.init(seed), mesh)")
        return self.mesh

    def fill(self, ts: SacTrainState) -> int:
        """The replay's global fill: a shard's or a rank's count times the
        shards when ``size`` counts local rows."""
        mesh = self.mesh_of(ts)
        local = self.cfg.shard_local_replay or (mesh is not None and not mesh.logical)
        return ts.buffer.size * (mesh.size if local else 1)

    def _policy_action(self, ts: SacTrainState, obs, random_phase: bool, d: dict, rows):
        """Uniform in [low, high] during warm-up (``d["uniform_actions"]`` are
        the actions themselves), else a squashed-Gaussian sample: gSDE's
        exploration matrices, or per-step noise (``d["noise"]``). ``rows``
        keeps this process's rows of a global-width draw."""
        B, dev, mesh = self.cfg.num_envs, self.device, self.mesh_of(ts)
        if random_phase:
            actions = d.get("uniform_actions")
            if actions is None:
                u = torch.rand((B, self.act_dim), generator=ts.generator, device=dev)
                actions = u * (self._high - self._low) + self._low
            return rows(actions)
        if self.cfg.use_sde:
            return per_shard(mesh, ts.actor.sample_sde, obs, ts.sde)
        noise = d.get("noise")
        if noise is None:
            noise = torch.randn((B, self.act_dim), generator=ts.generator, device=dev)
        return per_shard(mesh, lambda o, n: ts.actor.sample(o, noise=n)[0], obs, rows(noise))

    @torch.no_grad()
    def _env_cycle(self, ts: SacTrainState, draws=None):
        """``train_freq`` env steps on all envs, then ONE aligned buffer
        insert of the ``(train_freq * num_envs)`` rows, step-major (per shard
        with shard-local replay).

        ``draws``: one dict per step, any of ``resample`` (the gSDE normals,
        drawn every step as in JAX), ``uniform_actions``, ``noise`` and
        ``reset`` (the auto-reset's uniform block), all at the global width.
        Returns ``(ts, reward sum)``, the sum a 0-d device tensor over this
        process's envs.
        """
        cfg, dev = self.cfg, self.device
        B = cfg.num_envs
        mesh = self.mesh_of(ts)
        rows = mesh.local if mesh is not None else (lambda x: x)
        width = self.handle.n_uniform(self.handle.cfg)
        # threshold in collect-step units, as JAX (env_steps * num_envs could overflow)
        warmup_steps = -(-cfg.learning_starts // B)
        cols = {name: [] for name in ReplayBuffer.FIELDS}
        rewards = []
        for t in range(cfg.train_freq):
            d = draws[t] if draws is not None else {}
            frames = ts.batch.frames
            obs = frames.reshape(frames.shape[0], -1)
            if cfg.use_sde:
                normals = d.get("resample")
                if normals is None:
                    normals = torch.randn((B, *ts.sde.exploration_mat.shape[1:]),
                                          generator=ts.generator, device=dev)
                ts.sde = maybe_resample(ts.sde, None, cfg.sde_sample_freq, normals=rows(normals))
            actions = self._policy_action(ts, obs, ts.env_steps < warmup_steps, d, rows)
            reset = d.get("reset")
            if reset is None:
                reset = reset_uniform(ts.generator, B, width, dev)
            ts.batch, step = self.benv.step(ts.batch, actions, uniform=rows(reset))
            # next_obs: the frame stack continued with the terminal observation,
            # not the reset one; done is terminated only (truncation bootstraps)
            terminal = torch.cat([frames[:, 1:], step.info["terminal_observation"][:, None]], 1)
            for name, value in (("obs", obs), ("action", actions), ("reward", step.reward),
                                ("next_obs", terminal.reshape(obs.shape[0], -1)),
                                ("done", step.terminated.to(torch.float32))):
                cols[name].append(value)
            rewards.append(step.reward.sum())
            ts.env_steps += 1
        if cfg.shard_local_replay:
            buffer_add_traj_local(ts.buffer, {k: torch.stack(v) for k, v in cols.items()}, mesh)
        else:
            buffer_add_batch(ts.buffer, *(torch.cat(cols[name]) for name in ReplayBuffer.FIELDS),
                             aligned=True)
        return ts, torch.stack(rewards).sum()

    # -------------------------------------------------------------- updates

    def _update_draws(self, ts: SacTrainState, batch_size: int, generator) -> dict:
        """The draws of one update: replay indices (in global mode: shard-local
        replay draws its own, see :meth:`_sample`), the target's sample noise,
        the actor's sample noise and the CAPS spatial noise, at the global
        batch width."""
        dev = self.device
        d = {}
        if not self.cfg.shard_local_replay:
            d["idx"] = torch.randint(0, max(self.fill(ts), 1), (batch_size,), generator=generator,
                                     device=dev)
        d.update(
            noise_next=torch.randn((batch_size, self.act_dim), generator=generator, device=dev),
            noise_actor=torch.randn((batch_size, self.act_dim), generator=generator, device=dev),
            noise_spatial=torch.randn((batch_size, self.obs_dim), generator=generator, device=dev),
        )
        return d

    def _sample(self, ts: SacTrainState, batch_size: int, d: dict, seed: int):
        """This process's rows of the update's batch and of its noise, and the
        row count of the global means (``None``: the rows are the whole batch,
        so plain means).

        Shard-local replay: each shard's ``batch_size/n`` rows from its block
        (:func:`buffer_sample_local` with ``seed``), the noise rows at the
        same batch positions (shard-major). Global replay on ranks: the
        one-process run's indices, of which a rank evaluates those its envs
        wrote (global row ``g`` is env ``g % B`` of step-row ``g // B``)."""
        mesh = self.mesh_of(ts)
        noise = {k: d[k] for k in ("noise_next", "noise_actor", "noise_spatial")}
        ranks = mesh is not None and not mesh.logical
        if self.cfg.shard_local_replay:
            batch = buffer_sample_local(ts.buffer, batch_size, mesh, seed=seed, idx=d.get("idx"))
            return batch, {k: mesh.local(v) for k, v in noise.items()}, batch_size if ranks else None
        if not ranks:
            return buffer_sample(ts.buffer, batch_size, idx=d["idx"]), noise, None
        B = self.cfg.num_envs
        lo, hi = mesh.bounds(B)
        env = d["idx"] % B
        mine = torch.nonzero((env >= lo) & (env < hi)).squeeze(1)  # waits for the device
        local = (d["idx"] // B) * (hi - lo) + env - lo
        batch = buffer_sample(ts.buffer, batch_size, idx=local.index_select(0, mine))
        return batch, {k: v.index_select(0, mine) for k, v in noise.items()}, batch_size

    @staticmethod
    def _mean(x, total: Optional[int]):
        """A row mean over the global batch: this process's share of it when
        ``total`` (the global row count) is given."""
        return x.mean() if total is None else x.sum() / total

    def _critic_loss(self, ts: SacTrainState, batch, noise_next, total: Optional[int] = None):
        """Twin-Q regression on the soft target (pre-update actor, current
        alpha, target critic), computed without a graph."""
        cfg = self.cfg
        with torch.no_grad():
            next_action, next_logp, _ = ts.actor.sample(batch["next_obs"], noise=noise_next)
            q1_t, q2_t = ts.target_critic(batch["next_obs"], next_action)
            alpha = torch.exp(ts.log_alpha)
            target_v = torch.minimum(q1_t, q2_t) - alpha * next_logp
            target_q = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) * target_v
        q1, q2 = ts.critic(batch["obs"], batch["action"])
        return 0.5 * (self._mean(torch.square(q1 - target_q), total)
                      + self._mean(torch.square(q2 - target_q), total))

    def _actor_loss(self, ts: SacTrainState, batch, noise_actor, noise_spatial,
                    total: Optional[int] = None):
        """-> (loss, (mean log-prob, SAC loss, CAPS temporal, CAPS spatial)).

        The sample's mean action is ``deterministic(obs)`` (the same
        operations), so the CAPS terms reuse it instead of a fourth trunk
        forward."""
        cfg = self.cfg
        action, logp, mu_s = ts.actor.sample(batch["obs"], noise=noise_actor)
        q1, q2 = ts.critic(batch["obs"], action)
        alpha = torch.exp(ts.log_alpha).detach()
        sac_loss = self._mean(alpha * logp - torch.minimum(q1, q2), total)
        mu_next = ts.actor.deterministic(batch["next_obs"])
        mu_noisy = ts.actor.deterministic(batch["obs"] + cfg.eps_s * noise_spatial)
        caps_t = self._mean(torch.square(mu_s - mu_next).sum(-1), total)
        caps_s = self._mean(torch.square(mu_s - mu_noisy).sum(-1), total)
        loss = sac_loss + cfg.lambda_t * caps_t + cfg.lambda_s * caps_s
        return loss, (self._mean(logp, total), sac_loss, caps_t, caps_s)

    def _update_once(self, ts: SacTrainState, batch_size: Optional[int] = None, draws=None,
                     trace: Optional[dict] = None):
        """One update: the critic steps first; the actor loss then sees the
        UPDATED critic; the temperature steps on the actor loss's mean
        log-prob; the target critic blends in the new critic. ``draws``
        (:meth:`_update_draws`'s dict) replaces the draws from the training
        generator. On ranks the gradients and the mean log-prob are summed
        over the ranks (three all-reduces); ``trace``, a dict, receives those
        summed gradients."""
        cfg = self.cfg
        batch_size = batch_size or cfg.batch_size
        d = draws if draws is not None else self._update_draws(ts, batch_size, ts.generator)
        batch, noise, total = self._sample(ts, batch_size, d,
                                           derived_seed(ts.seed, ts.grad_steps, SAMPLE_TAG))
        mesh = self.mesh_of(ts)
        all_sum = mesh.all_sum if mesh is not None else list
        lr = self.lr_at(ts.grad_steps)

        critic_params = list(ts.critic.parameters())
        grads = all_sum(torch.autograd.grad(self._critic_loss(ts, batch, noise["noise_next"], total),
                                            critic_params))
        step_with(ts.critic_opt, critic_params, grads, lr)
        if trace is not None:
            trace["critic"] = grads

        actor_params = list(ts.actor.parameters())
        loss, (mean_logp, _, _, _) = self._actor_loss(ts, batch, noise["noise_actor"],
                                                      noise["noise_spatial"], total)
        grads = all_sum(torch.autograd.grad(loss, actor_params))
        step_with(ts.actor_opt, actor_params, grads, lr)
        mean_logp, = all_sum([mean_logp.detach()])
        if trace is not None:
            trace.update(actor=grads, mean_logp=mean_logp)

        # temperature: the gradient of -log_alpha * (mean_logp + target_entropy)
        step_with(ts.alpha_opt, [ts.log_alpha], [-(mean_logp + self.target_entropy)], lr)

        with torch.no_grad():
            target = list(ts.target_critic.parameters())
            torch._foreach_mul_(target, 1.0 - cfg.tau)
            torch._foreach_add_(target, torch._foreach_mul(critic_params, cfg.tau))
        ts.grad_steps += 1
        return ts

    # ----------------------------------------------------------- train loop

    def updates_per_round(self) -> int:
        return self.cfg.gradient_steps // self._fusion

    def train_rounds(self, ts: SacTrainState, n_rounds: int):
        """``n_rounds`` x {train_freq env steps + gradient_steps updates}.
        Returns ``(state, summed reward)``, the sum a 0-d device tensor over
        all envs (summed over the ranks).

        The warm-up gate is on the BUFFER FILL (a host integer), not the
        env-step counter: after a light-checkpoint resume (an empty buffer, a
        restored counter) only the fill gate re-warms properly."""
        cfg = self.cfg
        mesh = self.mesh_of(ts)
        if cfg.shard_local_replay and ts.buffer.blocks != mesh.size:
            raise ValueError(f"a replay of {ts.buffer.blocks} shard blocks on a mesh of "
                             f"{mesh.size}: re-lay it first (buffer_reshard_local)")
        rewards = []
        for _ in range(n_rounds):
            with span("usv.sac.collect"):
                ts, reward_sum = self._env_cycle(ts)
            rewards.append(reward_sum)
            if self.fill(ts) >= min(cfg.learning_starts, cfg.buffer_size):
                for _ in range(self.updates_per_round()):
                    with span("usv.sac.update"):
                        self._update_once(ts, batch_size=self._fusion * cfg.batch_size)
        total = torch.stack(rewards).sum()
        return ts, (mesh.all_sum([total])[0] if mesh is not None else total)

    # ---------------------------------------------------------- diagnostics

    def watch(self, ts: SacTrainState) -> dict:
        """Gradient/parameter diagnostics — the analog of the reference's
        ``wandb.watch`` (wandb_callback.py:126-131): global L2 norms of the
        actor/critic parameters and of their gradients on one diagnostic
        replay batch, the loss terms, the temperature and the sampled-policy
        entropy. Steps nothing and draws from its own generator; only
        meaningful once the buffer holds data. One read-back (and on ranks
        two all-reduces: the gradients, then the loss terms)."""
        seed = derived_seed(ts.seed, ts.env_steps, ts.grad_steps, WATCH_TAG)
        d = self._update_draws(ts, self.cfg.batch_size, new_generator(seed, self.device))
        batch, noise, total = self._sample(ts, self.cfg.batch_size, d, seed)
        mesh = self.mesh_of(ts)
        all_sum = mesh.all_sum if mesh is not None else list
        critic_params, actor_params = list(ts.critic.parameters()), list(ts.actor.parameters())
        critic_loss = self._critic_loss(ts, batch, noise["noise_next"], total)
        critic_grads = torch.autograd.grad(critic_loss, critic_params)
        actor_loss, (mean_logp, sac_loss, caps_t, caps_s) = self._actor_loss(
            ts, batch, noise["noise_actor"], noise["noise_spatial"], total)
        actor_grads = torch.autograd.grad(actor_loss, actor_params)
        grads = all_sum(list(critic_grads) + list(actor_grads))
        critic_grads, actor_grads = grads[:len(critic_params)], grads[len(critic_params):]
        losses = dict(critic_loss=critic_loss, actor_loss=actor_loss, sac_actor_loss=sac_loss,
                      caps_temporal=caps_t, caps_spatial=caps_s, policy_entropy=-mean_logp)
        losses = dict(zip(losses, all_sum([v.detach() for v in losses.values()])))
        values = dict(
            actor_param_norm=global_norm(actor_params),
            critic_param_norm=global_norm(critic_params),
            actor_grad_norm=global_norm(actor_grads),
            critic_grad_norm=global_norm(critic_grads),
            **losses,
            alpha=torch.exp(ts.log_alpha),
        )
        host = torch.stack([v.detach().float() for v in values.values()]).tolist()
        return dict(zip(values, host))

    # ----------------------------------------------------------- evaluation

    def eval_seed(self, ts: SacTrainState) -> int:
        """The seed of the eval at this point of the run (from the run's seed
        and counters; nothing is drawn)."""
        return derived_seed(ts.seed, ts.env_steps, ts.grad_steps, EVAL_TAG)

    def eval_policy(self, ts: SacTrainState, n_steps: int = 500, num_envs: int = 16) -> float:
        """Deterministic-policy rollout; returns mean reward per step."""
        return self.eval_policy_stats(ts, n_steps, num_envs)["reward_per_step"]

    def eval_policy_stats(self, ts: SacTrainState, n_steps: int = 500, num_envs: int = 16) -> dict:
        """Deterministic eval with outcome counts: ``reward_per_step`` plus
        ``episodes``/``terminations``/``truncations`` (and ``arriveds``/
        ``collisions`` where the env reports them), so that model selection
        can use the task metric."""
        return self.eval_policy_stats_at(ts.actor, self.eval_seed(ts), n_steps, num_envs)

    def eval_policy_stats_at(self, actor: SquashedGaussianActor, seed: int, n_steps: int = 500,
                             num_envs: int = 16) -> dict:
        """The exact :meth:`eval_policy_stats` program for any actor under an
        explicit seed — lets a bundle's recorded in-run eval be replayed bit
        for bit against the exported parameters (``run_eval
        --replay-recorded-eval``)."""
        benv = BatchedEnv(self.handle, num_envs, frame_stack=max(1, self.cfg.frame_stack),
                          sanitize=self.cfg.sanitize_envs)
        return eval_stats(benv, seed, actor.deterministic, n_steps)

    # ------------------------------------------------------- seed population

    def population_env(self, members: int) -> BatchedEnv:
        """The ``BatchedEnv`` of a population of ``members``: their
        ``members * num_envs`` envs as one batch."""
        if members not in self._benv_many:
            self._benv_many[members] = BatchedEnv(
                self.handle, members * self.cfg.num_envs, frame_stack=max(1, self.cfg.frame_stack),
                sanitize=self.cfg.sanitize_envs)
        return self._benv_many[members]

    def init_many(self, seeds: Sequence[int]) -> SacPopulationState:
        """A population of independent learners, one per seed: member ``i``
        starts as :meth:`init` ``(seeds[i])`` starts (the same weights, env
        resets, gSDE matrices and generator state), with an empty buffer of
        :attr:`buffer_capacity` rows of its own."""
        cfg, dev, B = self.cfg, self.device, self.cfg.num_envs
        seeds = [int(s) for s in seeds]
        actors, critics, generators, uniforms, mats = [], [], [], [], []
        width = self.handle.n_uniform(self.handle.cfg)
        for seed in seeds:
            with seeded_init(seed):
                actors.append(self.build_actor())
                critics.append(DoubleCritic(self.obs_dim, self.act_dim, cfg.hidden,
                                            compute_dtype=self.compute_dtype))
            g = new_generator(seed, dev)
            generators.append(g)
            uniforms.append(reset_uniform(g, B, width, dev))
            if cfg.use_sde:
                mats.append(init_sde(g, cfg.hidden[-1], self.act_dim, (B,), dev).exploration_mat)
        actor = Stacked.from_modules([m.to(dev) for m in actors])
        critic = Stacked.from_modules([m.to(dev) for m in critics])
        batch, _ = self.population_env(len(seeds)).reset(uniform=torch.cat(uniforms))
        sde = None
        if cfg.use_sde:
            mat = torch.cat(mats)
            sde = SdeState(exploration_mat=mat, step=torch.zeros(mat.shape[0], dtype=torch.int32,
                                                                 device=dev))
        log_alpha = torch.zeros(len(seeds), device=dev, requires_grad=True)
        lr = self.lr_at(0)
        return SacPopulationState(
            actor=actor, critic=critic, target_critic=critic.copy(), log_alpha=log_alpha,
            actor_opt=adam(actor.params, lr), critic_opt=adam(critic.params, lr),
            alpha_opt=adam([log_alpha], lr),
            buffer=buffer_init_many(len(seeds), self.buffer_capacity, self.obs_dim, self.act_dim,
                                    device=dev),
            batch=batch, generators=generators, seeds=seeds, sde=sde)

    @torch.no_grad()
    def _env_cycle_many(self, ps: SacPopulationState):
        """:meth:`_env_cycle` for every member at once: ``train_freq`` steps
        of the population's env batch, each member's draws from its own
        generator in the single learner's order, then one aligned insert of
        every member's ``train_freq * num_envs`` rows. Returns ``(ps, (S,)
        reward sums)``."""
        cfg, dev, B = self.cfg, self.device, self.cfg.num_envs
        S = len(ps.generators)
        benv = self.population_env(S)
        width = self.handle.n_uniform(self.handle.cfg)
        warmup_steps = -(-cfg.learning_starts // B)
        rows = {name: [] for name in ReplayBuffer.FIELDS}
        rewards = []
        for _ in range(cfg.train_freq):
            frames = ps.batch.frames
            obs = frames.reshape(S * B, -1)
            if cfg.use_sde:
                with span("usv.sac.member_draws"):
                    normals = per_member(ps.generators, lambda g: torch.randn(
                        (B, *ps.sde.exploration_mat.shape[1:]), generator=g, device=dev))
                ps.sde = maybe_resample(ps.sde, None, cfg.sde_sample_freq, normals=normals)
            if ps.env_steps < warmup_steps:
                with span("usv.sac.member_draws"):
                    u = per_member(ps.generators, lambda g: torch.rand((B, self.act_dim),
                                                                       generator=g, device=dev))
                actions = u * (self._high - self._low) + self._low
            elif cfg.use_sde:
                mat = ps.sde.exploration_mat
                actions = vmap_members(
                    lambda actor, o, m, k: actor.sample_sde(o, SdeState(exploration_mat=m, step=k)),
                    [ps.actor], obs.view(S, B, -1), mat.view(S, B, *mat.shape[1:]),
                    ps.sde.step.view(S, B)).reshape(S * B, -1)
            else:
                with span("usv.sac.member_draws"):
                    noise = per_member(ps.generators, lambda g: torch.randn((B, self.act_dim),
                                                                            generator=g, device=dev))
                actions = vmap_members(lambda actor, o, n: actor.sample(o, noise=n)[0], [ps.actor],
                                       obs.view(S, B, -1), noise.view(S, B, -1)).reshape(S * B, -1)
            with span("usv.sac.member_draws"):
                reset = per_member(ps.generators, lambda g: reset_uniform(g, B, width, dev))
            ps.batch, step = benv.step(ps.batch, actions, uniform=reset)
            terminal = torch.cat([frames[:, 1:], step.info["terminal_observation"][:, None]], 1)
            for name, value in (("obs", obs), ("action", actions), ("reward", step.reward),
                                ("next_obs", terminal.reshape(S * B, -1)),
                                ("done", step.terminated.to(torch.float32))):
                rows[name].append(value.view(S, B, *value.shape[1:]))
            rewards.append(step.reward.view(S, B).sum(1))
            ps.env_steps += 1
        # member-major, then step-major inside a member: the single learner's row order
        buffer_add_many(ps.buffer, *(torch.stack(rows[name], 1).flatten(1, 2)
                                     for name in ReplayBuffer.FIELDS))
        return ps, torch.stack(rewards).sum(0)

    def _update_draws_many(self, ps: SacPopulationState, batch_size: int) -> dict:
        """Each member's :meth:`_update_draws` from its own generator, stacked
        on the member axis."""
        with span("usv.sac.member_draws"):
            draws = [self._update_draws(ps, batch_size, g) for g in ps.generators]
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}

    def _critic_loss_many(self, ps: SacPopulationState, batch, noise_next):
        """Every member's :meth:`_critic_loss` through one ``vmap``: ``(S,)``."""
        def loss(actor, critic, target, log_alpha, batch, noise_next):
            view = types.SimpleNamespace(actor=actor, critic=critic, target_critic=target,
                                         log_alpha=log_alpha)
            return self._critic_loss(view, batch, noise_next)

        return vmap_members(loss, [ps.actor, ps.critic, ps.target_critic], ps.log_alpha, batch,
                            noise_next)

    def _actor_loss_many(self, ps: SacPopulationState, batch, noise_actor, noise_spatial):
        """Every member's :meth:`_actor_loss` through one ``vmap``: ``(S,)``
        losses and ``(S,)`` mean log-probs."""
        def loss(actor, critic, log_alpha, batch, noise_actor, noise_spatial):
            view = types.SimpleNamespace(actor=actor, critic=critic, log_alpha=log_alpha)
            loss, (mean_logp, _, _, _) = self._actor_loss(view, batch, noise_actor, noise_spatial)
            return loss, mean_logp

        return vmap_members(loss, [ps.actor, ps.critic], ps.log_alpha, batch, noise_actor,
                            noise_spatial)

    def _update_once_many(self, ps: SacPopulationState, batch_size: Optional[int] = None,
                          draws=None):
        """:meth:`_update_once` for every member at once: the members' critic
        losses, then actor losses, one backward pass on each sum, one Adam
        step over the stacked parameters. ``draws``
        (:meth:`_update_draws_many`'s dict) replaces the draws."""
        cfg = self.cfg
        batch_size = batch_size or cfg.batch_size
        d = draws if draws is not None else self._update_draws_many(ps, batch_size)
        batch = buffer_sample_many(ps.buffer, d["idx"])
        lr = self.lr_at(ps.grad_steps)

        loss = self._critic_loss_many(ps, batch, d["noise_next"])
        grads = torch.autograd.grad(loss.sum(), ps.critic.params)
        step_with(ps.critic_opt, ps.critic.params, grads, lr)

        loss, mean_logp = self._actor_loss_many(ps, batch, d["noise_actor"], d["noise_spatial"])
        grads = torch.autograd.grad(loss.sum(), ps.actor.params)
        step_with(ps.actor_opt, ps.actor.params, grads, lr)

        step_with(ps.alpha_opt, [ps.log_alpha], [-(mean_logp.detach() + self.target_entropy)], lr)

        with torch.no_grad():
            target = ps.target_critic.params
            torch._foreach_mul_(target, 1.0 - cfg.tau)
            torch._foreach_add_(target, torch._foreach_mul(ps.critic.params, cfg.tau))
        ps.grad_steps += 1
        return ps

    def train_rounds_many(self, ps: SacPopulationState, n_rounds: int):
        """:meth:`train_rounds` for the population; the warm-up gate on the
        shared fill stays a host integer. Returns ``(ps, (S,) summed
        rewards)``. Its spans are :meth:`train_rounds`' two, and
        ``usv.sac.member_draws`` around each host loop over the members'
        generators (the collect's and the updates' draws)."""
        cfg = self.cfg
        rewards = []
        for _ in range(n_rounds):
            with span("usv.sac.collect"):
                ps, reward_sum = self._env_cycle_many(ps)
            rewards.append(reward_sum)
            if ps.buffer.size >= min(cfg.learning_starts, cfg.buffer_size):
                for _ in range(self.updates_per_round()):
                    with span("usv.sac.update"):
                        self._update_once_many(ps, batch_size=self._fusion * cfg.batch_size)
        return ps, torch.stack(rewards).sum(0)

    def take_members(self, ps: SacPopulationState, keep: Sequence[int]) -> SacPopulationState:
        """The population of the members ``keep`` (the racing cull): their
        parameters and target parameters, Adam moments, temperatures, replay
        rows, env rows, frames, gSDE state and generators, as they were."""
        idx = torch.as_tensor(list(keep), dtype=torch.long, device=self.device)
        actor, critic = ps.actor.take(idx), ps.critic.take(idx)
        log_alpha = ps.log_alpha.detach().index_select(0, idx).requires_grad_(True)
        B = self.cfg.num_envs
        buffer = ReplayBuffer(**{f: getattr(ps.buffer, f).index_select(0, idx)
                                 for f in ReplayBuffer.FIELDS}, ptr=ps.buffer.ptr, size=ps.buffer.size)
        return SacPopulationState(
            actor=actor, critic=critic, target_critic=ps.target_critic.take(idx),
            log_alpha=log_alpha,
            actor_opt=take_adam(ps.actor_opt, ps.actor.params, actor.params, idx),
            critic_opt=take_adam(ps.critic_opt, ps.critic.params, critic.params, idx),
            alpha_opt=take_adam(ps.alpha_opt, [ps.log_alpha], [log_alpha], idx),
            buffer=buffer, batch=take_rows(ps.batch, idx, B),
            generators=[ps.generators[i] for i in keep], seeds=[ps.seeds[i] for i in keep],
            env_steps=ps.env_steps, grad_steps=ps.grad_steps,
            sde=take_rows(ps.sde, idx, B))

    def module_from(self, params: dict) -> SquashedGaussianActor:
        """An ordinary actor on the learner's device holding ``params`` (a
        member's :meth:`Stacked.member`): what the selection evaluates and
        the export saves."""
        actor = self.build_actor()
        actor.load_state_dict(params)
        return actor.to(self.device)

    def eval_seeds(self, ps: SacPopulationState) -> List[int]:
        """Each member's :meth:`eval_seed` at this point of the run."""
        return [derived_seed(seed, ps.env_steps, ps.grad_steps, EVAL_TAG) for seed in ps.seeds]

    def eval_policy_many(self, ps: SacPopulationState, n_steps: int = 500, num_envs: int = 16):
        """Per-member deterministic eval -> ``(S,)`` mean reward per step."""
        return self.eval_policy_stats_many(ps, n_steps, num_envs)["reward_per_step"]

    def eval_policy_stats_many(self, ps: SacPopulationState, n_steps: int = 500,
                               num_envs: int = 16) -> dict:
        """:meth:`eval_policy_stats` of every member in one batch of
        ``S * num_envs`` envs, member ``i``'s from its own eval seed: a dict
        of ``(S,)`` float arrays."""
        S = len(ps.seeds)
        benv = BatchedEnv(self.handle, S * num_envs, frame_stack=max(1, self.cfg.frame_stack),
                          sanitize=self.cfg.sanitize_envs)

        def act(obs):
            return vmap_members(lambda actor, o: actor.deterministic(o), [ps.actor],
                                obs.view(S, num_envs, -1)).reshape(S * num_envs, -1)

        return eval_stats_many(benv, self.eval_seeds(ps), act, n_steps)

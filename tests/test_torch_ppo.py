"""The port's PPO learner (``train/ppo.py``) against ``usv_tpu``'s, on the
CPU, at a small size (8 envs, hidden 32x32, ``frame_stack`` 2).

Weights cross through ``convert.state_dict_from_flax``, env states through
``convert.simple_state_from_numpy``, and the draws are rebuilt from JAX's
key chain (``split(key, n_steps)`` per collect, each step key drawing the
gSDE matrices or the sample noise; ``split(key, n_groups)`` per grouped
shuffle; each env's reset block from its own key). Tolerances and why:

* GAE: 1e-6 relative (the same recurrence, float32);
* minibatch layouts under the same permutations: equal;
* the loss and its gradients in float32: 2e-6 relative to the largest entry
  (means over 64 rows in two summation orders); with bfloat16 trunks the
  loss at 2e-2 relative and the gradients by their distance from the
  float32 gradient (the port's relative L2 error at most twice JAX's plus
  0.005), as in ``tests/test_torch_sac.py``;
* one minibatch step: where the JAX gradient exceeds 1e-4 the parameters
  agree at 2e-7 (a first Adam step is ``-lr * sign(g)``), elsewhere within
  ``2 * lr``;
* a collect of 6 steps with a forced termination and staggered truncations:
  2e-4 (the multi-step drift bound of the env tests), done flags equal;
* one whole iteration with fused optimizer steps, one shuffle and the lr
  anneal: the parameters' change within 1e-4 of its norm (that drift
  carried through the advantages into 4 Adam steps);
* the port against itself (eval on or off, a checkpoint resume): bit for bit.
"""

import dataclasses
import functools
import json
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")

from usv_tpu import envs as jenvs
from usv_tpu.train import ppo as jppo
from usv_tpu.utils import numpy_policy as jnumpy_policy
from usv_tpu_torch import convert
from usv_tpu_torch import envs as tenvs
from usv_tpu_torch.models.sde import SdeState
from usv_tpu_torch.train import checkpoint, policy as tpolicy, ppo as tppo
from usv_tpu_torch.vector import BatchState

SMALL = dict(n_steps=16, batch_size=32, n_epochs=2, num_envs=8, pi_hidden=(32, 32),
             vf_hidden=(32, 32), frame_stack=2)
B, A = 8, 2


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.array(v)
    return out


def to_numpy(state):
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name != "key":
            out[f.name] = to_numpy(v) if dataclasses.is_dataclass(v) else np.array(v)
    return out


def torch_tree(jax_tree):
    return convert.state_dict_from_flax(flatten(jax_tree))


def randomized(params, seed, scale=0.05):
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [leaf + scale * jnp.asarray(rng.standard_normal(leaf.shape), jnp.float32)
                                     for leaf in leaves])


def learners(dtype="float32", max_episode_steps=500, **overrides):
    cfg = dict(SMALL, compute_dtype=dtype, **overrides)
    jl = jppo.PpoLearner(jenvs.make("usv-simple", max_episode_steps=max_episode_steps),
                         jppo.PpoConfig(**cfg))
    tl = tppo.PpoLearner(tenvs.make("usv-simple", device="cpu", max_episode_steps=max_episode_steps),
                         tppo.PpoConfig(**cfg))
    return jl, tl


@functools.lru_cache(maxsize=None)
def jax_state(dtype="float32", **overrides):
    jl, _ = learners(dtype, **dict(overrides))
    jts = jl.init(seed=0)
    return jts.replace(params=randomized(jts.params, 2))


def torch_state(tl, jts):
    ts = tl.init(0)
    ts.model.load_state_dict(torch_tree(jts.params), strict=True)
    ts.batch = BatchState(env=convert.simple_state_from_numpy(to_numpy(jts.env_state), "cpu"),
                          frames=torch.from_numpy(np.array(jts.frames)))
    if jts.sde is not None:
        ts.sde = SdeState(torch.from_numpy(np.array(jts.sde.exploration_mat)),
                          torch.from_numpy(np.array(jts.sde.step)))
    return ts


def reference_gae(rewards, values, dones, last_value, gamma, lam):
    """``tests/test_gae.py``'s textbook reverse loop."""
    T = len(rewards)
    advs = np.zeros(T)
    adv = 0.0
    for t in reversed(range(T)):
        v_next = last_value if t == T - 1 else values[t + 1]
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * v_next * nonterm - values[t]
        adv = delta + gamma * lam * nonterm * adv
        advs[t] = adv
    return advs, advs + values


def test_gae_matches_jax_and_the_reference_loop():
    rng = np.random.default_rng(0)
    T, n = 12, 3
    traj = dict(reward=rng.normal(size=(T, n)), value=rng.normal(size=(T, n)),
                done=(rng.uniform(size=(T, n)) < 0.25))
    traj = {k: v.astype(np.float32) for k, v in traj.items()}
    last = rng.normal(size=n).astype(np.float32)
    advs, rets = tppo.PpoLearner._gae({k: torch.from_numpy(v) for k, v in traj.items()},
                                      torch.from_numpy(last), 0.99, 0.95)
    jadvs, jrets = jppo.PpoLearner._gae({k: jnp.asarray(v) for k, v in traj.items()},
                                        jnp.asarray(last), 0.99, 0.95)
    np.testing.assert_allclose(advs.numpy(), np.asarray(jadvs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rets.numpy(), np.asarray(jrets), rtol=1e-6, atol=1e-6)
    for b in range(n):
        want_adv, want_ret = reference_gae(traj["reward"][:, b], traj["value"][:, b],
                                           traj["done"][:, b], last[b], 0.99, 0.95)
        np.testing.assert_allclose(advs[:, b].numpy(), want_adv, rtol=1e-5)
        np.testing.assert_allclose(rets[:, b].numpy(), want_ret, rtol=1e-5)
    # a terminal last step cuts the bootstrap (tests/test_gae.py's second case)
    advs, _ = tppo.PpoLearner._gae(dict(reward=torch.tensor([[1.0], [1.0]]), value=torch.tensor([[0.5], [0.5]]),
                                        done=torch.tensor([[0.0], [1.0]])), torch.tensor([100.0]), 0.99, 0.95)
    assert float(advs[1, 0]) == pytest.approx(0.5, rel=1e-6)


def test_minibatch_layouts_on_given_permutations():
    rng = np.random.default_rng(1)
    T, n, S, eff = 6, 8, 4, 16
    tree = dict(obs=rng.standard_normal((T, n, 3)).astype(np.float32),
                logp=rng.standard_normal((T, n)).astype(np.float32))
    key = jax.random.key(4)
    want = jppo.grouped_minibatches({k: jnp.asarray(v) for k, v in tree.items()}, S, eff, key)
    perms = np.array(jax.vmap(lambda k: jax.random.permutation(k, T * n // S))(jax.random.split(key, S)))
    got = tppo.apply_grouped_minibatches({k: torch.from_numpy(v) for k, v in tree.items()}, S, eff,
                                         torch.from_numpy(perms).long())
    for k in tree:
        assert got[k].shape == (T * n // eff, eff, *tree[k].shape[2:])
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="shuffle_groups"):
        tppo.apply_grouped_minibatches({k: torch.from_numpy(v) for k, v in tree.items()}, 3, eff,
                                       torch.zeros((3, 16), dtype=torch.long))
    drawn = tppo.group_permutations(torch.Generator().manual_seed(0), S, T * n // S, "cpu")
    assert drawn.shape == (S, T * n // S)
    assert all(sorted(row.tolist()) == list(range(T * n // S)) for row in drawn)

    # the global shuffle: JAX's x[perm][:n_batches * eff].reshape(n_batches, eff, ...)
    _, tl = learners(n_steps=T, batch_size=12)
    traj = dict(obs=torch.from_numpy(tree["obs"]), action=torch.from_numpy(tree["obs"][..., :2]),
                logp=torch.from_numpy(tree["logp"]))
    advs, rets = traj["logp"] * 2, traj["logp"] * 3
    draw, batches, n_batches = tl._minibatches(traj, advs, rets)
    perm = draw(torch.Generator().manual_seed(2))
    laid = batches(perm)
    flat = np.asarray(tree["obs"]).reshape(T * n, -1)[perm.numpy()][: n_batches * 12]
    assert n_batches == 4 and np.array_equal(laid["obs"].numpy(), flat.reshape(4, 12, 3))
    np.testing.assert_array_equal(laid["ret"].numpy(),
                                  (rets.reshape(-1)[perm][:48]).reshape(4, 12).numpy())


def _loss_batch(obs_dim, seed=3, n=64):
    rng = np.random.default_rng(seed)
    return dict(obs=rng.standard_normal((n, obs_dim)).astype(np.float32),
                action=(0.3 * rng.standard_normal((n, A))).astype(np.float32),
                logp=(rng.standard_normal(n) + 2.0).astype(np.float32),
                adv=(2 * rng.standard_normal(n) + 0.5).astype(np.float32),
                ret=rng.standard_normal(n).astype(np.float32))


def _assert_grads(got, want, exact=None, rtol=2e-6):
    assert sorted(got) == sorted(want)
    if exact is not None:
        def flat(tree):
            return torch.cat([tree[n].flatten() for n in sorted(tree)])

        ref = flat(exact)
        ours = float((flat(got) - ref).norm() / ref.norm())
        theirs = float((flat(want) - ref).norm() / ref.norm())
        assert ours <= 2 * theirs + 0.005, (ours, theirs)
        return
    scale = max(float(w.abs().max()) for w in want.values())
    for name in got:
        assert float((got[name] - want[name]).abs().max()) <= rtol * scale, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(dtype):
    jl, tl = learners(dtype)
    jts = jax_state(dtype)
    ts = torch_state(tl, jts)
    batch = _loss_batch(tl.obs_dim)
    args = (0.2, 0.01, 0.5)  # clip range, entropy and value coefficients
    jloss, jgrads = jax.value_and_grad(jl._loss)(jts.params, {k: jnp.asarray(v) for k, v in batch.items()},
                                                 *args)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tl._loss(ts.model, tbatch, *args)
    grads = torch.autograd.grad(loss, list(ts.model.parameters()))
    rtol = 2e-6 if dtype == "float32" else 2e-2
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=rtol)
    exact = None
    if dtype == "bfloat16":
        jl32, _ = learners()
        exact = torch_tree(jax.grad(jl32._loss)(jax_state().params,
                                                {k: jnp.asarray(v) for k, v in batch.items()}, *args))
    _assert_grads(dict(zip([n for n, _ in ts.model.named_parameters()], grads)), torch_tree(jgrads), exact)
    # (the float32 loss at 2e-6 pins the population standard deviation of
    # the advantage normalisation: torch's default, ddof 1, moves every
    # advantage by 0.8% at 64 rows)


def test_minibatch_step_matches_jax():
    """One optimizer step (gradients, clip by global norm 0.5, Adam) on a
    batch whose gradient norm exceeds the clip, against JAX's ``minibatch``
    body (``jax.grad(_loss)``, ``tx.update``, ``apply_updates``)."""
    import optax

    jl, tl = learners()
    jts = jax_state()
    ts = torch_state(tl, jts)
    batch = _loss_batch(tl.obs_dim, seed=6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = jl.cfg
    jgrads = jax.grad(jl._loss)(jts.params, jbatch, cfg.clip_range, cfg.ent_coef, cfg.vf_coef)
    assert float(optax.global_norm(jgrads)) > cfg.max_grad_norm  # the clip is live
    updates, _ = jl.tx.update(jgrads, jts.opt_state, jts.params)
    want = torch_tree(optax.apply_updates(jts.params, updates))
    g = torch_tree(jgrads)
    tl._minibatch_step(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert ts.opt_steps == 1
    lr = cfg.learning_rate
    for name, value in ts.model.state_dict().items():
        err = (value - want[name]).abs()
        assert float(torch.where(g[name].abs() > 1e-4, err, 0.0).max()) <= 2e-7, name
        assert float(err.max()) <= 2 * lr + 2e-7, name


def _uniform_chain(keys, n, steps):
    block = jax.jit(jax.vmap(lambda k: jax.random.uniform(jax.random.split(jax.random.split(k)[1])[0],
                                                          (n,), jnp.float32)))
    advance = jax.jit(jax.vmap(lambda k: jax.random.split(k)[0]))
    out = []
    for _ in range(steps):
        out.append(torch.from_numpy(np.array(block(keys))))
        keys = advance(keys)
    return out


@pytest.mark.parametrize("use_sde", [True, False], ids=["gsde", "plain"])
def test_collect_matches_jax_with_the_truncation_bootstrap(use_sde):
    T, MAX = 6, 4
    jl, tl = learners(n_steps=T, use_sde=use_sde, max_episode_steps=MAX)
    jts = jax_state(n_steps=T, use_sde=use_sde, max_episode_steps=MAX)
    env = jts.env_state
    xy, mask = np.array(env.obs_xy), np.array(env.obs_mask)
    xy[0, 0], mask[0, 0] = np.array(env.position)[0, :2], True  # env 0 terminates at once
    env = env.replace(step_count=jnp.arange(B, dtype=jnp.int32) % MAX, obs_xy=jnp.asarray(xy),
                      obs_mask=jnp.asarray(mask))
    jts = jts.replace(env_state=env)
    ts = torch_state(tl, jts)
    key = jax.random.key(7)
    resets = _uniform_chain(env.key, tl.handle.n_uniform(tl.handle.cfg), T)
    draws = []
    for t, step_key in enumerate(jax.random.split(key, T)):
        shape = (B, 32, A) if use_sde else (B, A)
        d = {"resample" if use_sde else "noise": torch.from_numpy(np.array(jax.random.normal(step_key, shape))),
             "reset": resets[t]}
        draws.append(d)

    jnew, jtraj, jlast = jax.jit(jl._collect)(jts, key)
    ts, traj, last = tl._collect(ts, draws)
    for k in ("obs", "action", "logp", "value", "reward", "raw_reward"):
        assert traj[k].shape == jtraj[k].shape, k
        np.testing.assert_allclose(traj[k].numpy(), np.asarray(jtraj[k]), atol=2e-4, rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(traj["done"].numpy(), np.asarray(jtraj["done"]))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(ts.batch.frames.numpy(), np.asarray(jnew.frames), atol=2e-4, rtol=0)
    if use_sde:
        np.testing.assert_array_equal(ts.sde.step.numpy(), np.asarray(jnew.sde.step))
    # the bootstrap is live: truncated steps add gamma * V(terminal frames),
    # every other step's reward is the env's
    boosted = (traj["reward"] != traj["raw_reward"])
    assert int(boosted.sum()) >= T - 1 and traj["done"][0, 0] == 1
    assert not bool((boosted & (traj["done"] == 0)).any())
    assert bool(traj["raw_reward"][0, 0] == traj["reward"][0, 0])  # a termination: no bootstrap


def test_rotation_permutes_the_carried_state():
    _, tl = learners(shuffle_groups=2, shuffle_group_rotate=True, n_steps=4)
    ts = tl.init(1)
    ts, traj, last = tl._collect(ts)
    before = (ts.batch.frames.clone(), ts.batch.env.position.clone(), ts.sde.exploration_mat.clone())
    perm = torch.tensor([3, 0, 7, 1, 6, 2, 5, 4])
    n_local = 4 * B // 2
    perms = [torch.stack([torch.randperm(n_local), torch.randperm(n_local)]) for _ in range(2)]
    tl._update(ts, traj, last, draws=dict(perms=perms, rotate=perm))
    # jnp.take(x, perm, axis=0): row i of the new state is row perm[i] of the old
    assert torch.equal(ts.batch.frames, before[0][perm])
    assert torch.equal(ts.batch.env.position, before[1][perm])
    assert torch.equal(ts.sde.exploration_mat, before[2][perm])
    assert ts.update_count == 1 and ts.opt_steps == 2  # 2 epochs of one 32-row minibatch
    # without the rotation flag the state stays in place
    _, tl = learners(shuffle_groups=2, n_steps=4)
    ts = tl.init(1)
    ts, traj, last = tl._collect(ts)
    frames = ts.batch.frames.clone()
    tl._update(ts, traj, last)
    assert torch.equal(ts.batch.frames, frames)


def test_lr_schedule_follows_optimizer_steps():
    import optax

    _, tl = learners(lr_decay_updates=8, lr_final_fraction=0.0, n_steps=8)
    sched = optax.linear_schedule(3e-4, 0.0, 8)
    for c in (0, 1, 5, 8, 9):
        assert tl.lr_at(c) == pytest.approx(float(sched(c)), rel=1e-6, abs=1e-12)
    ts = tl.init(0)
    ts, _ = tl.train_iteration(ts)
    # 8 steps x 8 envs / batch 32 = 2 minibatches x 2 epochs
    assert ts.opt_steps == 4 and ts.opt.param_groups[0]["lr"] == pytest.approx(float(sched(3)))
    _, const = learners()
    assert const.lr_at(0) == const.lr_at(10**6) == 3e-4


def _snapshot(ts):
    out = {}

    def walk(v, name):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(x, f"{name}.{k}")
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(x, f"{name}.{i}")
        else:
            out[name] = v
    walk(checkpoint._pack(ts), "ts")
    return out


def _assert_same(a, b):
    sa, sb = _snapshot(a), _snapshot(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]) if isinstance(sa[k], torch.Tensor) else sa[k] == sb[k], k


def test_eval_and_watch_leave_training_unchanged():
    _, tl = learners(n_steps=8)
    plain, evaluated = tl.init(2), tl.init(2)
    for _ in range(3):
        tl.train_iteration(plain)
        tl.train_iteration(evaluated)
        stats = tl.eval_policy_stats(evaluated, n_steps=5, num_envs=3)
        assert tl.eval_policy_stats_at(evaluated.model, tl.eval_seed(evaluated), 5, 3) == stats
        watched = tl.watch(evaluated)
    _assert_same(plain, evaluated)
    jl, _ = learners()
    assert set(watched) == set(jl.watch(jl.init(0)))
    assert watched["log_std_mean"] == pytest.approx(-2.0, abs=0.05) and watched["param_norm"] > 0
    assert set(stats) == set(jl.eval_policy_stats(jl.init(0), n_steps=3, num_envs=2))


def test_checkpoint_resume_is_exact(tmp_path):
    _, tl = learners(n_steps=8, shuffle_groups=2, shuffle_group_rotate=True)
    straight = tl.init(4)
    for _ in range(3):
        tl.train_iteration(straight)
    resumed = tl.init(4)
    tl.train_iteration(resumed)
    checkpoint.save_checkpoint(tmp_path / "ckpt", resumed, 64)
    fresh, step = checkpoint.restore_checkpoint(tmp_path / "ckpt", tl.init(77))
    assert step == 64
    _assert_same(fresh, resumed)
    for _ in range(2):
        tl.train_iteration(fresh)
    _assert_same(fresh, straight)


def test_export_load_numpy_and_replay(tmp_path):
    _, tl = learners(n_steps=8)
    ts = tl.init(5)
    tl.train_iteration(ts)
    stats = tl.eval_policy_stats(ts, n_steps=6, num_envs=3)
    meta = tpolicy.in_run_eval_meta("usv-simple", "reward", stats["reward_per_step"], stats,
                                    tl.eval_seed(ts), 6, 3)
    bundle = tpolicy.export_policy(tl, ts, tmp_path / "best", extra_meta=meta)
    saved = json.loads((tmp_path / "best" / "policy.json").read_text())
    assert set(saved) - {"in_run_eval"} == {"kind", "obs_dim", "action_dim", "pi_hidden", "vf_hidden",
                                            "log_std_init", "action_low", "action_high", "use_sde",
                                            "frame_stack", "compute_dtype"}
    assert saved["kind"] == "ppo" and saved["action_low"] == [0.2, -1.0]
    served = tpolicy.load_policy(bundle, device="cpu")
    obs = torch.from_numpy(np.random.default_rng(0).standard_normal((5, tl.obs_dim)).astype(np.float32))
    with torch.no_grad():
        want = torch.clamp(ts.model.pi_mean(ts.model.pi_trunk(obs)), tl._low, tl._high)
    assert torch.equal(served(obs), want)
    npz = tpolicy.export_numpy_policy(bundle)
    np.testing.assert_allclose(jnumpy_policy.load_numpy_policy(npz)(obs.numpy()), want.numpy(),
                               atol=1e-5, rtol=1e-5)
    rep = tpolicy.replay_recorded_eval(tl.handle, bundle)
    assert rep["recorded"] == rep["replayed"] and rep["stats"] == stats
    with pytest.raises(ValueError, match="recorded eval ran on"):
        tpolicy.replay_recorded_eval(tenvs.make("usv-asmc-simple", device="cpu"), bundle)


def test_short_budget_learning_check():
    """Three iterations on the cheap kinematic env: finite rewards, and the
    value head fits the iteration's returns (its loss on the rollout drops)."""
    _, tl = learners(n_steps=32, n_epochs=4)
    ts = tl.init(3)
    rewards = []
    for _ in range(3):
        ts, traj, last = tl._collect(ts)
        _, returns = tl._gae(traj, last, tl.cfg.gamma, tl.cfg.gae_lambda)
        obs = traj["obs"].reshape(-1, tl.obs_dim)

        def v_loss():
            with torch.no_grad():
                return float(torch.square(ts.model.value_only(obs) - returns.reshape(-1)).mean())

        before = v_loss()
        tl._update(ts, traj, last)
        assert v_loss() < before
        rewards.append(float(traj["raw_reward"].mean()))
    assert all(np.isfinite(rewards)) and ts.update_count == 3
    assert all(torch.isfinite(p).all() for p in ts.model.parameters())


def test_an_iteration_with_fused_steps_and_one_shuffle_matches_jax():
    """One whole ``train_iteration`` under the at-scale recipe's update
    geometry, against JAX's: two minibatches fused into each optimizer step
    (``update_fusion``), one shuffle for every epoch (``reshuffle_epochs``
    off), the lr annealed over optimizer steps, and episodes truncating
    inside the rollout (GAE across auto-resets). The port is fed the draws
    of JAX's key chain: ``split(ts.key, 3)`` gives the collect's key (its
    per-step gSDE draws, as in the collect test) and the shuffle's
    permutation. The parameters' change over the iteration (4 optimizer
    steps) agrees within 1e-4 of its norm (1.1e-5 measured: the collect's
    float drift through the advantages); the same iteration under another
    shuffle, or with the epochs reshuffled, lands 1e-2 or more from JAX's
    (0.46 and 0.087 measured), so the bound tells the layouts apart."""
    T, MAX = 16, 6
    over = dict(update_fusion=2, reshuffle_epochs=False, lr_decay_updates=8, max_episode_steps=MAX)
    jl, tl = learners(**over)
    jts = jax_state(**over)
    _, k_collect, k_perm = jax.random.split(jts.key, 3)
    n_total = T * B
    resets = _uniform_chain(jts.env_state.key, tl.handle.n_uniform(tl.handle.cfg), T)
    collect = [{"resample": torch.from_numpy(np.array(jax.random.normal(k, (B, 32, A)))), "reset": resets[t]}
               for t, k in enumerate(jax.random.split(k_collect, T))]
    perm = torch.from_numpy(np.array(jax.random.permutation(k_perm, n_total))).long()

    # (the jitted iteration donates its input's buffers: hand it a copy)
    jnew, jreward = jl.train_iteration(jax.tree.map(lambda x: x.copy(), jts))
    before = torch_tree(jts.params)
    want = {k: v - before[k] for k, v in torch_tree(jnew.params).items()}

    def moved(perms, **cfg):
        _, learner = learners(**dict(over, **cfg))
        ts = torch_state(learner, jts)
        ts, reward = learner.train_iteration(ts, draws=dict(collect=collect, perms=perms))
        return ts, reward, {k: v - before[k] for k, v in ts.model.state_dict().items()}

    def gap(got):
        num = sum(float((got[k] - want[k]).square().sum()) for k in want)
        return (num / sum(float(w.square().sum()) for w in want.values())) ** 0.5

    ts, reward, got = moved([perm])
    assert ts.opt_steps == 2 * (n_total // 64) == 4 and ts.update_count == 1
    assert ts.opt.param_groups[0]["lr"] == pytest.approx(3e-4 * (1 - 3 / 8), rel=1e-6)
    assert float(reward) == pytest.approx(float(jreward), rel=1e-5)
    # every env truncated inside the rollout and both sides reset it alike
    counts = np.array(jnew.env_state.step_count)
    assert np.array_equal(ts.batch.env.step_count.numpy(), counts) and (counts < T).all()
    assert gap(got) <= 1e-4
    other = torch.from_numpy(np.random.default_rng(0).permutation(n_total)).long()
    assert gap(moved([other])[2]) >= 1e-2
    assert gap(moved([perm, other], reshuffle_epochs=True)[2]) >= 1e-2

"""The port's SAC learner (``train/sac.py``), its checkpoints and the learner
helpers (``train/common.py``) against ``usv_tpu``, on the CPU, at the size
of ``tests/test_train.py``'s ``SMALL_SAC`` (8 envs, hidden 64x64,
``frame_stack`` 2).

Weights cross through ``convert.state_dict_from_flax``, env states through
``convert.simple_state_from_numpy``, and every draw is rebuilt from JAX's key
chain (``split(key, 4)`` per update, ``split(k_actor)`` in the actor loss,
``split(step_key)`` per collect step, ``split(split(k)[1])[0]`` for a
reset's uniform block from each env's key). Tolerances and why:

* losses and gradients in float32: 2e-6 relative to the largest entry
  (sums of up to 64 rows and 130-input products in two summation orders);
  with bfloat16 trunks the losses at 2e-2 relative (a bfloat16 ulp is
  0.4%, and the two sides round products and bias adds differently, as in
  ``test_torch_models``), and the gradients by their distance from the
  float32 gradient: the port's relative L2 error is at most twice JAX's own
  bfloat16 error plus 0.005 (both are 1-6% here: a bfloat16 backward pass
  carries that error whoever computes it);
* one ``_update_once``: the first Adam step is ``-lr * g / (|g| + eps)``,
  ``-lr * sign(g)`` wherever ``|g|`` is far above ``eps``; where the JAX
  gradient exceeds 1e-4 (two orders above the gradient differences above)
  the two sides' parameters agree at 2e-7 (the float32 rounding of
  ``p - lr``); elsewhere a near-zero gradient may take the other sign on
  the other side and the parameter may move by up to ``2 * lr``;
* the optimizer step fed the SAME gradients against ``optax.adam`` (with
  the linear schedule) and ``optax.chain(clip_by_global_norm, adam)``:
  1e-6 relative (the same formula, rounded in another order);
* ``_env_cycle`` over 6 steps with a forced termination and staggered
  truncations: buffer rows at 2e-4 (the multi-step drift bound of the env
  tests: each side's env evolves on its own), done flags equal;
* the port against itself (eval on or off, a checkpoint resume): bit for bit.
"""

import dataclasses
import functools
import json
import warnings
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")

from usv_tpu import envs as jenvs
from usv_tpu.train import sac as jsac
from usv_tpu.utils import numpy_policy as jnumpy_policy
from usv_tpu_torch import convert
from usv_tpu_torch import envs as tenvs
from usv_tpu_torch.models.sde import SdeState
from usv_tpu_torch.parallel import make_env_mesh
from usv_tpu_torch.train import checkpoint, common, policy as tpolicy, sac as tsac
from usv_tpu_torch.vector import BatchState

SMALL = dict(buffer_size=4096, batch_size=64, learning_starts=256, num_envs=8, train_freq=4,
             gradient_steps=2, hidden=(64, 64), frame_stack=2)
B, A = 8, 2
GRAD_RTOL = {"float32": 2e-6, "bfloat16": 2e-2}


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
    """A flax params (or gradients) tree in the port's ``state_dict`` layout."""
    return convert.state_dict_from_flax(flatten(jax_tree))


def randomized(params, seed, scale=0.05):
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [leaf + scale * jnp.asarray(rng.standard_normal(leaf.shape), jnp.float32)
                                     for leaf in leaves])


def learners(dtype="float32", **overrides):
    cfg = dict(SMALL, compute_dtype=dtype, **overrides)
    max_steps = cfg.pop("max_episode_steps", 500)
    jl = jsac.SacLearner(jenvs.make("usv-simple", max_episode_steps=max_steps), jsac.SacConfig(**cfg))
    tl = tsac.SacLearner(tenvs.make("usv-simple", device="cpu", max_episode_steps=max_steps),
                         tsac.SacConfig(**cfg))
    return jl, tl


@functools.lru_cache(maxsize=None)
def jax_state(dtype="float32", fill=512, **overrides):
    """A JAX train state with perturbed networks, log_alpha 0.3 and ``fill``
    random replay rows."""
    jl, _ = learners(dtype, **dict(overrides))
    jts = jl.init(seed=0)
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((fill, jl.obs_dim)).astype(np.float32)
    buf = jts.buffer
    if fill:
        from usv_tpu.train.buffer import buffer_add_batch

        buf = buffer_add_batch(buf, obs, rng.uniform(-1, 1, (fill, A)).astype(np.float32),
                               rng.standard_normal(fill).astype(np.float32),
                               obs + 0.1 * rng.standard_normal(obs.shape).astype(np.float32),
                               (rng.random(fill) < 0.2).astype(np.float32))
    critic = randomized(jts.critic_params, 3)
    return jts.replace(actor_params=randomized(jts.actor_params, 2), critic_params=critic,
                       target_critic_params=randomized(critic, 4, 0.02),
                       log_alpha=jnp.float32(0.3), buffer=buf)


def torch_state(tl, jts):
    """The port's train state holding ``jts``'s networks, buffer, envs and
    counters (the optimizers fresh, as ``jts``'s are)."""
    ts = tl.init(0)
    ts.actor.load_state_dict(torch_tree(jts.actor_params), strict=True)
    ts.critic.load_state_dict(torch_tree(jts.critic_params), strict=True)
    ts.target_critic.load_state_dict(torch_tree(jts.target_critic_params), strict=True)
    with torch.no_grad():
        ts.log_alpha.fill_(float(jts.log_alpha))
        for name in ("obs", "action", "reward", "next_obs", "done"):
            getattr(ts.buffer, name).copy_(torch.from_numpy(np.array(getattr(jts.buffer, name))))
    ts.buffer.ptr, ts.buffer.size = int(jts.buffer.ptr), int(jts.buffer.size)
    ts.batch = BatchState(env=convert.simple_state_from_numpy(to_numpy(jts.env_state), "cpu"),
                          frames=torch.from_numpy(np.array(jts.frames)))
    ts.sde = SdeState(torch.from_numpy(np.array(jts.sde.exploration_mat)),
                      torch.from_numpy(np.array(jts.sde.step)))
    ts.env_steps, ts.grad_steps = int(jts.env_steps), int(jts.grad_steps)
    return ts


def update_draws(jts, key, batch_size, obs_dim):
    """The draws of JAX's ``_update_once(ts, key)``: ``split(key, 4)``, then
    ``split(k_actor)`` inside ``_actor_loss``."""
    k_batch, k_critic, k_actor, _ = jax.random.split(key, 4)
    k_sample, k_spatial = jax.random.split(k_actor)
    draw = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return dict(
        idx=draw(jax.random.randint(k_batch, (batch_size,), 0, jnp.maximum(jts.buffer.size, 1))).long(),
        noise_next=draw(jax.random.normal(k_critic, (batch_size, A))),
        noise_actor=draw(jax.random.normal(k_sample, (batch_size, A))),
        noise_spatial=draw(jax.random.normal(k_spatial, (batch_size, obs_dim))),
    ), (k_batch, k_critic, k_actor)


def assert_grads(got_named, want_tree, rtol, what, exact_tree=None):
    """float32: every entry within ``rtol`` of the largest JAX entry. With
    ``exact_tree`` (the float32 gradient, for a bfloat16 run): the port's
    relative L2 distance from it at most twice JAX's plus 0.005."""
    want = torch_tree(want_tree)
    assert sorted(got_named) == sorted(want), what
    if exact_tree is not None:
        exact = torch_tree(exact_tree)

        def flat(tree):
            return torch.cat([tree[n].flatten() for n in sorted(tree)])

        ref = flat(exact)
        ours = float((flat(got_named) - ref).norm() / ref.norm())
        theirs = float((flat(want) - ref).norm() / ref.norm())
        assert ours <= 2 * theirs + 0.005, f"{what}: bfloat16 error {ours} against JAX's {theirs}"
        return
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in got_named.items():
        err = float((g - want[name]).abs().max())
        assert err <= rtol * scale, f"{what} {name}: {err} > {rtol} x {scale}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_losses_and_gradients_match_jax(dtype):
    jl, tl = learners(dtype)
    jts = jax_state(dtype)
    ts = torch_state(tl, jts)
    jl32, jts32 = learners()[0], jax_state()  # the same parameters, float32 products
    bf16 = dtype == "bfloat16"
    d, (k_batch, k_critic, k_actor) = update_draws(jts, jax.random.key(11), 64, tl.obs_dim)
    jbatch = jsac.buffer_sample(jts.buffer, k_batch, 64)
    batch = tsac.buffer_sample(ts.buffer, 64, idx=d["idx"])
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)
    rtol = GRAD_RTOL[dtype]

    jloss, jgrads = jax.value_and_grad(jl._critic_loss)(jts.critic_params, jts, jbatch, k_critic)
    names = [n for n, _ in ts.critic.named_parameters()]
    loss = tl._critic_loss(ts, batch, d["noise_next"])
    grads = torch.autograd.grad(loss, list(ts.critic.parameters()))
    loss = loss.detach()
    assert float(loss) == pytest.approx(float(jloss), rel=rtol)
    exact = jax.grad(jl32._critic_loss)(jts32.critic_params, jts32, jbatch, k_critic) if bf16 else None
    assert_grads(dict(zip(names, grads)), jgrads, rtol, "critic", exact)

    (jloss, jaux), jgrads = jax.value_and_grad(jl._actor_loss, has_aux=True)(
        jts.actor_params, jts, jbatch, k_actor)
    loss, aux = tl._actor_loss(ts, batch, d["noise_actor"], d["noise_spatial"])
    grads = torch.autograd.grad(loss, list(ts.actor.parameters()))
    loss, aux = loss.detach(), [a.detach() for a in aux]
    assert float(loss) == pytest.approx(float(jloss), rel=rtol)
    # aux: mean log-prob, SAC loss, CAPS temporal, CAPS spatial
    for got, want in zip(aux, jaux):
        assert float(got) == pytest.approx(float(want), rel=rtol, abs=rtol * abs(float(jloss)))
    exact = jax.grad(lambda p: jl32._actor_loss(p, jts32, jbatch, k_actor)[0])(
        jts32.actor_params) if bf16 else None
    assert_grads(dict(zip([n for n, _ in ts.actor.named_parameters()], grads)), jgrads, rtol, "actor",
                 exact)
    assert all(p.grad is None for p in ts.critic.parameters())  # nothing reached the critic

    # the temperature's gradient on the actor loss's mean log-prob
    jal = jax.grad(lambda la: -la * jax.lax.stop_gradient(jaux[0] + jl.target_entropy))(jts.log_alpha)
    assert float(-(aux[0] + tl.target_entropy)) == pytest.approx(float(jal), rel=rtol)


def test_update_once_matches_jax():
    jl, tl = learners()
    jts = jax_state()
    ts = torch_state(tl, jts)
    key = jax.random.key(12)
    d, _ = update_draws(jts, key, 64, tl.obs_dim)
    # the gradients of the pre-update state on the JAX side, for the masks
    k_batch, k_critic, k_actor, _ = jax.random.split(key, 4)
    jbatch = jsac.buffer_sample(jts.buffer, k_batch, 64)
    g_critic = torch_tree(jax.grad(jl._critic_loss)(jts.critic_params, jts, jbatch, k_critic))
    before = {k: v.clone() for k, v in ts.critic.state_dict().items()}

    want = jax.jit(jl._update_once)(jts, key)
    tl._update_once(ts, draws=d)
    assert ts.grad_steps == int(want.grad_steps) == 1
    lr = tl.cfg.learning_rate

    def compare(module, flax_params, grads_of=None):
        for name, value in module.state_dict().items():
            ref = torch_tree(flax_params)[name]
            err = (value - ref).abs()
            if grads_of is not None:
                firm = grads_of[name].abs() > 1e-4
                assert float(torch.where(firm, err, 0.0).max()) <= 2e-7, name
            assert float(err.max()) <= 2 * lr + 2e-7, name

    compare(ts.critic, want.critic_params, g_critic)
    moved = torch.cat([(ts.critic.state_dict()[k] - before[k]).abs().flatten() for k in before])
    assert float(moved.max()) == pytest.approx(lr, rel=1e-3)  # a first Adam step: lr * sign(g)
    # the actor's gradients see the updated critic: the same masks, from the
    # JAX actor gradient under JAX's updated critic
    jmid = jts.replace(critic_params=want.critic_params)
    g_actor = torch_tree(jax.grad(lambda p: jl._actor_loss(p, jmid, jbatch, k_actor)[0])(jts.actor_params))
    compare(ts.actor, want.actor_params, g_actor)
    # Polyak with the NEW critic
    compare(ts.target_critic, want.target_critic_params)
    assert float(ts.log_alpha.detach()) == pytest.approx(float(want.log_alpha), abs=2e-7)
    assert abs(float(ts.log_alpha.detach()) - 0.3) == pytest.approx(lr, rel=1e-3)


def _jax_adam_steps(tx, params, grads_seq):
    state = tx.init(params)
    for g in grads_seq:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params


@pytest.mark.parametrize("kind", ["sac_schedule", "ppo_clip_schedule"])
def test_optimizer_step_on_identical_gradients_matches_optax(kind):
    rng = np.random.default_rng(5)
    shapes = [(7, 3), (3,), ()]
    params = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    # gradients of several magnitudes: the global norm crosses 0.5 both ways
    grads_seq = [[np.asarray(rng.standard_normal(s) * scale, np.float32) for s in shapes]
                 for scale in (2.0, 0.01, 1.0, 0.05, 3.0)]
    lr, T = 3e-4, 3
    if kind == "sac_schedule":
        tx = optax.adam(optax.linear_schedule(lr, lr * 0.1, T))
        schedule = common.linear_schedule(lr, lr * 0.1, T)
    else:
        tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(optax.linear_schedule(lr, 0.0, T)))
        schedule = common.linear_schedule(lr, 0.0, T)
    want = _jax_adam_steps(tx, [jnp.asarray(p) for p in params],
                           [[jnp.asarray(g) for g in gs] for gs in grads_seq])
    tparams = [torch.tensor(p, requires_grad=True) for p in params]
    opt = common.adam(tparams, schedule(0))
    for count, gs in enumerate(grads_seq):
        grads = [torch.from_numpy(g) for g in gs]
        if kind != "sac_schedule":
            grads = common.clip_by_global_norm(grads, 0.5)
        common.step_with(opt, tparams, grads, schedule(count))
    for got, ref in zip(tparams, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)
    # the schedule itself, at counts below, at and past its horizon
    jsched = optax.linear_schedule(lr, lr * 0.1, 20)
    ours = common.linear_schedule(lr, lr * 0.1, 20)
    for c in (0, 1, 7, 19, 20, 21, 500):
        assert ours(c) == pytest.approx(float(jsched(c)), rel=1e-6)
    # the clip: optax's g / n * m with no epsilon, identity below the norm
    g = [torch.tensor([3.0, 4.0])]
    assert torch.equal(common.clip_by_global_norm(g, 0.5)[0], g[0] / 5.0 * 0.5)
    assert torch.equal(common.clip_by_global_norm(g, 5.0 + 1e-3)[0], g[0])


def _uniform_chain(keys, n, steps):
    """Each env's reset block per step from its JAX key: the auto-reset
    splits ``next, reset = split(key)``, the reset draws
    ``uniform(split(reset)[0], (n,))`` and the env carries ``next``."""
    block = jax.jit(jax.vmap(lambda k: jax.random.uniform(jax.random.split(jax.random.split(k)[1])[0],
                                                          (n,), jnp.float32)))
    advance = jax.jit(jax.vmap(lambda k: jax.random.split(k)[0]))
    out = []
    for _ in range(steps):
        out.append(torch.from_numpy(np.array(block(keys))))
        keys = advance(keys)
    return out


def collect_draws(jl, key, keys0, n_uniform, steps):
    """The draws of JAX's ``_env_cycle(ts, key)``: ``split(key, train_freq)``,
    ``split(step_key)`` into resample and action keys, ``split(k_action)``
    into the uniform and the sample key."""
    low, high = jnp.asarray(jl.action_low), jnp.asarray(jl.action_high)
    resets = _uniform_chain(keys0, n_uniform, steps)
    draws = []
    for t, step_key in enumerate(jax.random.split(key, steps)):
        k_resample, k_action = jax.random.split(step_key)
        k1, k2 = jax.random.split(k_action)
        draws.append(dict(
            resample=torch.from_numpy(np.array(jax.random.normal(k_resample, (B, 64, A)))),
            uniform_actions=torch.from_numpy(np.array(
                jax.random.uniform(k1, (B, A), minval=low, maxval=high))),
            noise=torch.from_numpy(np.array(jax.random.normal(k2, (B, A)))),
            reset=resets[t]))
    return draws


@pytest.mark.parametrize("phase", ["warmup", "actor"])
def test_env_cycle_matches_jax(phase):
    T, MAX = 6, 5
    starts = 10**6 if phase == "warmup" else 0
    jl, tl = learners(train_freq=T, learning_starts=starts, max_episode_steps=MAX, buffer_size=48 * 4)
    jts = jax_state("float32", fill=0, train_freq=T, learning_starts=starts,
                    max_episode_steps=MAX, buffer_size=48 * 4)
    env = jts.env_state
    # staggered truncations, and env 0 starts with an obstacle on its boat
    xy = np.array(env.obs_xy)
    xy[0, 0] = np.array(env.position)[0, :2]
    mask = np.array(env.obs_mask)
    mask[0, 0] = True
    env = env.replace(step_count=jnp.arange(B, dtype=jnp.int32) % MAX, obs_xy=jnp.asarray(xy),
                      obs_mask=jnp.asarray(mask))
    jts = jts.replace(env_state=env)
    ts = torch_state(tl, jts)
    key = jax.random.key(13)
    draws = collect_draws(jl, key, env.key, tl.handle.n_uniform(tl.handle.cfg), T)

    jnew, jreward = jax.jit(jl._env_cycle)(jts, key)
    ts, reward = tl._env_cycle(ts, draws)
    assert ts.env_steps == int(jnew.env_steps) == T and ts.buffer.size == int(jnew.buffer.size) == T * B
    assert ts.buffer.ptr == int(jnew.buffer.ptr)
    rows = slice(0, T * B)
    for name in ("obs", "action", "reward", "next_obs"):
        np.testing.assert_allclose(getattr(ts.buffer, name)[rows].numpy(),
                                   np.asarray(getattr(jnew.buffer, name))[rows], atol=2e-4, rtol=0,
                                   err_msg=name)
    done = ts.buffer.done[rows].reshape(T, B)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jnew.buffer.done)[rows].reshape(T, B))
    assert float(reward) == pytest.approx(float(jreward), abs=2e-4 * T * B)
    np.testing.assert_allclose(ts.batch.frames.numpy(), np.asarray(jnew.frames), atol=2e-4, rtol=0)
    np.testing.assert_allclose(ts.sde.exploration_mat.numpy(), np.asarray(jnew.sde.exploration_mat))
    if phase == "warmup":
        np.testing.assert_array_equal(ts.buffer.action[rows].reshape(T, B, A).numpy(),
                                      np.stack([d["uniform_actions"].numpy() for d in draws]))
    # done is the termination only: env 0 terminates at once (done 1); the
    # staggered truncations end episodes that the buffer stores as not done
    obs = ts.buffer.obs[rows].reshape(T, B, -1)
    nxt = ts.buffer.next_obs[rows].reshape(T, B, -1)
    D = tl.handle.cfg.obs_dim
    ended = (obs[1:] != nxt[:-1]).any(-1)  # the next row is a reset's obs
    assert ended[0, 0] and done[0, 0] == 1
    assert (ended & (done[:-1] == 0)).sum() >= T - 2
    assert not (~ended & (done[:-1] == 1)).any()
    # next_obs continues the frame stack: its older frame is obs's newest
    assert torch.equal(nxt[..., :D], obs[..., D:])


def test_warmup_switch_update_gate_and_capacity_warning():
    jl, tl = learners()
    assert tl.buffer_capacity == jl.buffer_capacity == 4096
    for n_envs, tf, size in ((10, 4, 4096), (1024, 64, 400_000)):
        cfg = dict(SMALL, num_envs=n_envs, train_freq=tf, buffer_size=size)
        with pytest.warns(UserWarning, match="rounded") as rec:
            got = tsac.SacLearner(tenvs.make("usv-simple", device="cpu"), tsac.SacConfig(**cfg))
        with warnings.catch_warnings(record=True) as jrec:
            warnings.simplefilter("always")
            want = jsac.SacLearner(jenvs.make("usv-simple"), jsac.SacConfig(**cfg))
        assert got.buffer_capacity == want.buffer_capacity
        assert str(rec[0].message) == str(jrec[0].message)
    assert got.buffer_capacity == 458_752  # the at-scale recipe's 400k rows
    # learning_starts of 2.5 steps of 8 envs: steps 0-2 are uniform, then the actor
    _, tl = learners(learning_starts=20, train_freq=5, buffer_size=4000)
    ts = tl.init(0)
    sentinel = torch.full((B, A), 0.5)
    draws = [dict(uniform_actions=sentinel) for _ in range(5)]
    tl._env_cycle(ts, draws)
    acts = ts.buffer.action[:40].reshape(5, B, A)
    assert all(torch.equal(acts[t], sentinel) for t in range(3))
    assert not any(torch.equal(acts[t], sentinel) for t in (3, 4))
    # the update gate on the buffer's fill, as tests/test_train.py counts JAX's:
    # updates from round 8 of 20 with full fusion, 2 per round at fusion 2
    for overrides, rounds, expected in ((dict(fused_updates=True), 20, 13),
                                        (dict(gradient_steps=4, update_fusion=2), 10, 6)):
        _, tl = learners(**overrides)
        ts, reward = tl.train_rounds(tl.init(0), rounds)
        assert ts.grad_steps == expected and torch.isfinite(reward)
        assert all(torch.isfinite(p).all() for p in ts.actor.parameters())
    handle = tenvs.make("usv-simple", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tsac.SacLearner(handle, tsac.SacConfig(**dict(SMALL, gradient_steps=4, update_fusion=3)))
    # shard-local replay needs the mesh, and widths that divide it (JAX's checks)
    with pytest.raises(ValueError, match="needs the device mesh"):
        tsac.SacLearner(handle, tsac.SacConfig(**dict(SMALL, shard_local_replay=True)))
    with pytest.raises(ValueError, match="must divide the mesh size"):
        tsac.SacLearner(handle, tsac.SacConfig(**dict(SMALL, shard_local_replay=True)),
                        mesh=make_env_mesh(n_shards=3))


def _snapshot(ts):
    """Every tensor of a train state, by name, for bitwise comparison."""
    packed = checkpoint._pack(ts)
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
    walk(packed, "ts")
    return out


def _assert_same(a, b):
    sa, sb = _snapshot(a), _snapshot(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        if isinstance(sa[k], torch.Tensor):
            assert torch.equal(sa[k], sb[k]), k
        else:
            assert sa[k] == sb[k], k


def test_eval_and_watch_leave_training_unchanged():
    _, tl = learners(learning_starts=64)
    plain, evaluated = tl.init(3), tl.init(3)
    for _ in range(4):
        tl.train_rounds(plain, 2)
        tl.train_rounds(evaluated, 2)
        stats = tl.eval_policy_stats(evaluated, n_steps=5, num_envs=3)
        assert tl.eval_policy_stats_at(evaluated.actor, tl.eval_seed(evaluated), 5, 3) == stats
        watched = tl.watch(evaluated)
    _assert_same(plain, evaluated)
    assert plain.grad_steps > 0
    jl, _ = learners()
    jstats = jl.eval_policy_stats(jl.init(0), n_steps=5, num_envs=3)
    assert set(stats) == set(jstats)
    jwatch = jl.watch(jl.train_rounds(jl.init(0), 10)[0])
    assert set(watched) == set(jwatch) and all(np.isfinite(v) for v in watched.values())
    assert watched["alpha"] > 0 and watched["critic_grad_norm"] > 0
    # the CA env reports outcomes: arriveds and collisions, as JAX's eval
    ca = tsac.SacLearner(tenvs.make("usv-asmc-ca-v0", device="cpu"), tsac.SacConfig(**SMALL))
    s = ca.eval_policy_stats(ca.init(0), n_steps=3, num_envs=2)
    assert {"arriveds", "collisions"} <= set(s) and ca.eval_policy(ca.init(0), 3, 2) == s["reward_per_step"]


def test_mirrored_learner_needs_log_alpha_for_equal_gradients():
    """A second learner given a trained one's networks and buffer (as the
    card-against-CPU checks build theirs) reproduces its gradients bit for
    bit only once it holds the trained ``log_alpha`` too: the critic
    target's entropy term and the actor loss read the current temperature."""
    from usv_tpu_torch.train.buffer import ReplayBuffer, buffer_sample

    _, tl = learners(learning_starts=64)
    trained = tl.init(0)
    tl.train_rounds(trained, 3)
    assert trained.grad_steps > 0 and not torch.equal(trained.log_alpha, tl.init(0).log_alpha)
    draws = tl._update_draws(trained, 64, trained.generator)

    def grads(ts):
        batch = buffer_sample(ts.buffer, 64, idx=draws["idx"])
        critic = torch.autograd.grad(tl._critic_loss(ts, batch, draws["noise_next"]),
                                     list(ts.critic.parameters()))
        loss, _ = tl._actor_loss(ts, batch, draws["noise_actor"], draws["noise_spatial"])
        return critic + torch.autograd.grad(loss, list(ts.actor.parameters()))

    want = grads(trained)
    mirror = tl.init(1)
    for name in ("actor", "critic", "target_critic"):
        getattr(mirror, name).load_state_dict(getattr(trained, name).state_dict())
    for field in ReplayBuffer.FIELDS:
        getattr(mirror.buffer, field).copy_(getattr(trained.buffer, field))
    mirror.buffer.ptr, mirror.buffer.size = trained.buffer.ptr, trained.buffer.size
    assert not all(torch.equal(a, b) for a, b in zip(grads(mirror), want))
    with torch.no_grad():
        mirror.log_alpha.copy_(trained.log_alpha)
    assert all(torch.equal(a, b) for a, b in zip(grads(mirror), want))


@pytest.mark.parametrize("light", [False, True], ids=["full", "light"])
def test_checkpoint_resume_is_exact(tmp_path, light):
    _, tl = learners(learning_starts=64)
    straight = tl.init(5)
    tl.train_rounds(straight, 5)
    resumed = tl.init(5)
    tl.train_rounds(resumed, 3)
    path = checkpoint.save_checkpoint(tmp_path / "ckpt", resumed, 3 * 4 * B, include_buffer=not light)
    assert path.endswith("/96/train_state.pt")
    fresh = tl.init(99)  # another seed: everything must come from the file
    fresh, step = checkpoint.restore_checkpoint(tmp_path / "ckpt", fresh)
    assert step == 96
    if light:
        assert fresh.buffer.size == 0 and fresh.env_steps == 12
        # re-warms from an empty buffer: the first round fills 32 of the 64
        # rows the gate needs, the second updates twice
        tl.train_rounds(fresh, 2)
        assert fresh.buffer.size == 64 and fresh.grad_steps == resumed.grad_steps + 2
        return
    _assert_same(fresh, resumed)
    tl.train_rounds(fresh, 2)
    _assert_same(fresh, straight)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(tmp_path / "none", tl.init(0))
    _, other = learners(num_envs=4)
    with pytest.raises(ValueError, match="does not fit"):
        checkpoint.restore_checkpoint(tmp_path / "ckpt", other.init(0))


def test_export_load_numpy_and_replay(tmp_path):
    _, tl = learners(learning_starts=64)
    ts = tl.init(6)
    tl.train_rounds(ts, 3)
    stats = tl.eval_policy_stats(ts, n_steps=6, num_envs=3)
    meta = tpolicy.in_run_eval_meta("usv-simple", "reward", stats["reward_per_step"], stats,
                                    tl.eval_seed(ts), 6, 3)
    bundle = tpolicy.export_policy(tl, ts, tmp_path / "best", extra_meta=meta)
    saved = json.loads((tmp_path / "best" / "policy.json").read_text())
    jl, _ = learners()
    jbundle_keys = {"kind", "obs_dim", "action_dim", "hidden", "log_std_init", "action_low",
                    "action_high", "use_sde", "frame_stack", "compute_dtype"}
    assert set(saved) == jbundle_keys | {"in_run_eval"} and saved["kind"] == "sac"
    assert saved["action_low"] == list(jl.action_low) and saved["hidden"] == [64, 64]
    served = tpolicy.load_policy(bundle, device="cpu")
    obs = torch.from_numpy(np.random.default_rng(0).standard_normal((5, tl.obs_dim)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(served(obs), ts.actor.deterministic(obs))
    npz = tpolicy.export_numpy_policy(bundle)
    np.testing.assert_allclose(jnumpy_policy.load_numpy_policy(npz)(obs.numpy()), served(obs).numpy(),
                               atol=1e-5, rtol=1e-5)
    rep = tpolicy.replay_recorded_eval(tl.handle, bundle)
    assert rep["recorded"] == rep["replayed"] and rep["stats"] == stats
    # a bundle whose in-run eval records a JAX key is refused
    jmeta = dict(saved, in_run_eval=dict(saved["in_run_eval"], key_data=[0, 7]))
    del jmeta["in_run_eval"]["seed"]
    (tmp_path / "best" / "policy.json").write_text(json.dumps(jmeta))
    with pytest.raises(ValueError, match="JAX key cannot be replayed by torch's generators"):
        tpolicy.replay_recorded_eval(tl.handle, bundle)
    with pytest.raises(ValueError, match="no recorded"):
        tpolicy.replay_recorded_eval(tl.handle, tpolicy.export_policy(tl, ts, tmp_path / "final"))
    with pytest.raises(TypeError):
        tpolicy.export_policy(object(), ts, tmp_path / "x")


def test_bf16_training_keeps_float32_masters():
    _, tl = learners("bfloat16", learning_starts=64)
    ts = tl.init(0)
    tl.train_rounds(ts, 4)
    assert ts.grad_steps == 3 * 2  # the buffer holds 64 rows from round 2 on
    for opt in (ts.actor_opt, ts.critic_opt):
        for state in opt.state.values():
            assert state["exp_avg"].dtype == torch.float32
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in ts.actor.parameters())
    assert tl.compute_dtype == torch.bfloat16 and ts.actor.trunk.compute_dtype == torch.bfloat16

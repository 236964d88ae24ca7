"""The port's batch layer on the CPU: nested select, pooled auto-reset, frame
stack, guards, ``BatchedEnv`` and the registry, against ``usv_tpu``.

* ``BatchedEnv`` for the four ids, with and without a frame stack, against
  the JAX ``BatchedEnv`` over 10 auto-reset steps at B=8 with staggered
  TimeLimit truncations (``max_episode_steps=5``, step counters offset per
  env). At every step the port is fed the uniform blocks JAX's key chain
  draws (``split(key)[1]`` -> ``split(...)[0]`` -> ``uniform``) and the same
  numpy actions, its state evolving on its own: obs, reward, the stacked obs
  and ``terminal_observation`` within 2e-4 (the drift bound of the multi-step
  env tests), done flags equal.
* The pooled auto-reset equals the full-width one when both are fed the same
  fresh states, at steps with 0, 1, F and more than F done envs (atol=1e-6:
  the same float32 ops, on blocks of other heights).
* ``push_frames`` against JAX, refilling on done.
* The guard on a batch where one env diverges: only that env terminates, its
  reward and poisoned leaves are zeroed and ``info["diverged"]`` is set;
  flags and cleaned values equal the vmapped JAX guard's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")

from usv_tpu import envs as jenvs
from usv_tpu.utils import guards as jguards
from usv_tpu.vector import frames as jframes
from usv_tpu.vector.batch import BatchedEnv as JaxBatchedEnv
from usv_tpu_torch import envs as tenvs
from usv_tpu_torch.envs.autoreset import _select, default_reset_pool
from usv_tpu_torch.envs.types import tree_leaves, tree_map
from usv_tpu_torch.utils import guards as tguards
from usv_tpu_torch.vector import BatchedEnv, BatchState, frames as tframes, rollout

CPU = torch.device("cpu")
IDS = ["usv-simple", "usv-asmc-simple", "usv-aitsmc-simple", "usv-asmc-ca-v0"]
B, T, MAX_STEPS, STACK = 8, 10, 5, 3


def to_numpy(state):
    """A vmapped JAX state as a (nested) dict of numpy arrays, keys dropped."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name != "key":
            out[f.name] = to_numpy(v) if dataclasses.is_dataclass(v) else np.array(v)
    return out


def _inner(env_state):
    """The state that carries ``key`` and ``step_count``."""
    return env_state.base if hasattr(env_state, "base") else env_state


def _with_inner(env_state, inner):
    return env_state.replace(base=inner) if hasattr(env_state, "base") else inner


def _actions(env_id, rng):
    if env_id == "usv-asmc-ca-v0":
        return rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    return np.stack([rng.uniform(0.2, 1.0, B), rng.uniform(-0.6, 0.6, B)], 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_trajectory(env_id):
    """The JAX ``BatchedEnv`` run: the reset's uniform block and, per step,
    the block its key chain draws, the actions and the outputs."""
    handle = jenvs.make(env_id, max_episode_steps=MAX_STEPS)
    benv = JaxBatchedEnv(handle, B, frame_stack=STACK)
    n = tenvs.make(env_id, device="cpu").n_uniform(tenvs.make(env_id, device="cpu").cfg)
    first = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0], (n,), jnp.float32))
    later = jax.jit(jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(jax.random.split(k)[1])[0], (n,), jnp.float32)))
    key = jax.random.key(5)
    state, obs = benv.reset(key)
    u0 = np.array(first(jax.random.split(key, B)))
    stagger = jnp.arange(B, dtype=jnp.int32) % MAX_STEPS
    inner = _inner(state.env)
    state = state.replace(env=_with_inner(state.env, inner.replace(step_count=stagger)))
    rng = np.random.default_rng(5)
    steps = []
    for _ in range(T):
        action = _actions(env_id, rng)
        u = np.array(later(_inner(state.env).key))
        state, ts = benv.step(state, jnp.asarray(action))
        steps.append(dict(
            u=u, action=action, obs=np.array(ts.obs), reward=np.array(ts.reward),
            done=np.array(ts.done), stacked=np.array(state.stacked_obs),
            terminal=np.array(ts.info["terminal_observation"])))
    return u0, np.array(obs), steps


@pytest.mark.parametrize("frame_stack", [0, STACK])
@pytest.mark.parametrize("env_id", IDS)
def test_batched_env_matches_jax(env_id, frame_stack):
    u0, obs0, steps = jax_trajectory(env_id)
    handle = tenvs.make(env_id, device="cpu", max_episode_steps=MAX_STEPS)
    benv = BatchedEnv(handle, B, frame_stack=frame_stack)
    state, obs = benv.reset(0, uniform=torch.from_numpy(u0))
    np.testing.assert_allclose(obs.numpy(), obs0, atol=1e-5, rtol=0)
    inner = _inner(state.env)
    stagger = torch.arange(B, dtype=torch.int32) % MAX_STEPS
    state = BatchState(env=_with_inner(state.env, inner.replace(step_count=stagger)),
                       frames=state.frames)
    if frame_stack:
        assert state.stacked_obs.shape == (B, STACK * handle.cfg.obs_dim)
    else:
        with pytest.raises(ValueError, match="frame stacking disabled"):
            state.stacked_obs
    dones = 0
    for t, want in enumerate(steps):
        state, ts = benv.step(state, torch.from_numpy(want["action"]),
                              uniform=torch.from_numpy(want["u"]))
        for name, got in [("obs", ts.obs), ("reward", ts.reward),
                          ("terminal", ts.info["terminal_observation"])]:
            np.testing.assert_allclose(got.numpy(), want[name], atol=2e-4, rtol=0,
                                       err_msg=f"step {t}: {name}")
        np.testing.assert_array_equal(ts.done.numpy(), want["done"], err_msg=f"step {t}")
        if frame_stack:
            np.testing.assert_allclose(state.stacked_obs.numpy(), want["stacked"], atol=2e-4,
                                       rtol=0, err_msg=f"step {t}: stacked obs")
        dones += int(ts.done.sum())
    assert dones >= 2 * B - 2  # staggered: some env resets at every step


@pytest.mark.parametrize("env_id", IDS)
def test_batched_env_draws_from_its_generator(env_id):
    handle = tenvs.make(env_id, device="cpu", max_episode_steps=2)
    outs = []
    for source in (3, torch.Generator().manual_seed(3), 4):
        benv = BatchedEnv(handle, 4, frame_stack=2, sanitize=True)
        state, obs = benv.reset(source)
        for _ in range(3):
            state, ts = benv.step(state, torch.zeros(4, 2))
        assert "diverged" in ts.info and not ts.info["diverged"].any()
        outs.append(ts.obs)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert torch.isfinite(outs[0]).all() and state.frames.shape == (4, 2, handle.cfg.obs_dim)


def _pool_schedule():
    """B=8, F=3: no env done at step 0, one at step 1, three (F) at step 2,
    four (more than F) at step 3."""
    done_at = torch.tensor([2, 3, 1, 3, 2, 3, 3, 2])
    return done_at, [int((done_at == t).sum()) for t in range(4)]


@pytest.mark.parametrize("env_id", ["usv-asmc-ca-v0", "usv-aitsmc-simple"])
def test_pooled_autoreset_equals_full_width(env_id):
    F, limit = 3, 50
    done_at, counts = _pool_schedule()
    assert counts == [0, 1, F, 4]
    handle = tenvs.make(env_id, device="cpu", max_episode_steps=limit)
    n = handle.n_uniform(handle.cfg)
    full = BatchedEnv(handle, B, reset_pool=0)
    pooled = BatchedEnv(handle, B, reset_pool=F)
    g = torch.Generator().manual_seed(8)
    u0 = torch.rand((B, n), generator=g)
    states = {}
    for name, benv in (("full", full), ("pooled", pooled)):
        s, _ = benv.reset(0, uniform=u0)
        inner = _inner(s.env)
        s = BatchState(env=_with_inner(s.env, inner.replace(
            step_count=(limit - 1 - done_at).to(torch.int32))), frames=None)
        states[name] = s
    actions = torch.zeros(B, 2)
    for t, count in enumerate(counts):
        pool_block = torch.rand((B, n), generator=g)
        full_block = torch.rand((B, n), generator=g)
        rows = torch.nonzero(done_at == t)[:, 0]
        if count <= F:
            # the i-th done env takes pool entry i: give the full-width path
            # that entry in that env's own row
            full_block[rows] = pool_block[:count]
        else:
            pool_block = full_block  # the pooled step takes the full-width path
        states["full"], fts = full.step(states["full"], actions, uniform=full_block)
        states["pooled"], pts = pooled.step(states["pooled"], actions, uniform=pool_block)
        assert fts.done.tolist() == (done_at == t).tolist(), f"step {t}"
        assert torch.equal(pts.done, fts.done)
        torch.testing.assert_close(pts.obs, fts.obs, atol=1e-6, rtol=0)
        torch.testing.assert_close(pts.info["terminal_observation"],
                                   fts.info["terminal_observation"], atol=1e-6, rtol=0)
        for a, b in zip(tree_leaves(states["pooled"].env), tree_leaves(states["full"].env)):
            if a.is_floating_point():
                torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
            else:
                assert torch.equal(a, b)
        if count:
            # a done env's obs is its fresh episode's reset obs, not the old one's
            assert not torch.allclose(pts.obs[rows], pts.info["terminal_observation"][rows])


def test_pooled_autoreset_draws_only_the_pool():
    """With a generator the pooled step draws F rows, the full-width one B:
    the generator's state after a step tells them apart."""
    handle = tenvs.make("usv-asmc-ca-v0", device="cpu")
    n = handle.n_uniform(handle.cfg)
    after = {}
    for pool in (0, 2):
        benv = BatchedEnv(handle, B, reset_pool=pool)
        state, _ = benv.reset(1)
        benv.step(state, torch.zeros(B, 2))
        after[pool] = benv.generator.get_state()
    g = torch.Generator().manual_seed(1)
    torch.rand((B, n), generator=g)
    torch.rand((2, n), generator=g)
    assert torch.equal(after[2], g.get_state()) and not torch.equal(after[0], after[2])
    assert default_reset_pool(4096) == 0
    with pytest.raises(ValueError, match="generator"):
        BatchedEnv(handle, B)._auto_step(state.env, torch.zeros(B, 2))


def test_select_walks_nested_states():
    handle = tenvs.make("usv-asmc-simple", device="cpu")
    g = torch.Generator().manual_seed(2)
    old = handle.reset(handle.cfg, g, 6, CPU)
    new = handle.reset(handle.cfg, g, 6, CPU)
    new = tree_map(lambda leaf: leaf + 1 if leaf.is_floating_point() else leaf, new)
    done = torch.tensor([True, False, True, False, False, True])
    out = _select(done, new, old)
    assert type(out) is type(old) and type(out.base) is type(old.base)
    for o, a, b in zip(tree_leaves(out), tree_leaves(new), tree_leaves(old)):
        assert torch.equal(o[done], a[done]) and torch.equal(o[~done], b[~done])
    assert len(tree_leaves(out)) == 15 + 10 + 2
    assert torch.equal(out.ctrl.ka_u, torch.where(done, new.ctrl.ka_u, old.ctrl.ka_u))


def test_push_frames_refills_on_done():
    rng = np.random.default_rng(3)
    obs0 = rng.normal(size=(5, 4)).astype(np.float32)
    jf, tf = jframes.init_frames(jnp.asarray(obs0), 3), tframes.init_frames(torch.from_numpy(obs0), 3)
    assert tf.shape == (5, 3, 4)
    for t in range(4):
        obs = rng.normal(size=(5, 4)).astype(np.float32)
        done = rng.random(5) < 0.4
        jf = jframes.push_frames(jf, jnp.asarray(obs), jnp.asarray(done))
        tf = tframes.push_frames(tf, torch.from_numpy(obs), torch.from_numpy(done))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        for i in np.nonzero(done)[0]:
            assert (tf[i] == torch.from_numpy(obs[i])).all()  # the whole stack refilled
    assert tframes.init_frames(torch.zeros(2, 4), 0).shape == (2, 1, 4)


def test_guard_isolates_the_diverged_env():
    jcfg = jenvs.make("usv-asmc-ca-v0").cfg
    handle = tenvs.make("usv-asmc-ca-v0", device="cpu")
    from usv_tpu.envs import asmc_ca as jca
    from usv_tpu_torch.convert import ca_state_from_numpy

    n = 6
    jstate = jax.jit(jax.vmap(lambda k: jca.reset(jcfg, k)))(jax.random.split(jax.random.key(2), n))
    # env 2 carries an exploded surge speed: its next step overflows to inf/NaN
    vel = np.array(jstate.dyn.vel)
    vel[2] = [3e19, 0.0, 0.0]
    jstate = jstate.replace(dyn=jstate.dyn.replace(vel=jnp.asarray(vel)))
    tstate = ca_state_from_numpy(to_numpy(jstate), CPU)
    action = np.zeros((n, 2), np.float32)

    raw_state, raw_ts = handle.step(handle.cfg, tstate, torch.from_numpy(action))
    finite = tguards.is_state_finite(raw_state)
    sane = tguards.is_state_sane(raw_state)
    assert finite.shape == sane.shape == (n,)
    assert sane.tolist() == [True, True, False, True, True, True]
    assert not finite[2] and finite[[0, 1, 3, 4, 5]].all()

    jguard = jax.vmap(jguards.make_sanitized_step(jca.step, jcfg))
    jnew, jts = jguard(jstate, jnp.asarray(action))
    tnew, tts = tguards.make_sanitized_step(handle.step, handle.cfg)(tstate, torch.from_numpy(action))
    assert tts.info["diverged"].tolist() == np.asarray(jts.info["diverged"]).tolist() \
        == [False, False, True, False, False, False]
    assert tts.terminated[2] and float(tts.reward[2]) == 0.0
    np.testing.assert_array_equal(tts.terminated.numpy(), np.asarray(jts.terminated))
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), atol=1e-5)
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs), atol=1e-5)
    for leaf, raw in zip(tree_leaves(tnew), tree_leaves(raw_state)):
        assert torch.isfinite(leaf.float()).all()
        keep = [0, 1, 3, 4, 5]
        assert torch.equal(leaf[keep], raw[keep])  # the other envs are untouched
    assert (tnew.dyn.vel[2] == 0).all() and (tnew.dyn.pose[2].abs() < 1e4).all()
    np.testing.assert_allclose(tnew.dyn.vel.numpy(), np.asarray(jnew.dyn.vel), atol=1e-5)

    with pytest.raises(FloatingPointError, match="non-finite"):
        tguards.checked_step(handle.step)(handle.cfg, tstate, torch.from_numpy(action))
    keep = torch.tensor([0, 1, 3, 4, 5])
    good = tree_map(lambda leaf: leaf[keep], tstate)
    checked_state, _ = tguards.checked_step(handle.step)(handle.cfg, good, torch.zeros(5, 2))
    assert torch.equal(checked_state.dyn.pose, raw_state.dyn.pose[keep])


@pytest.mark.parametrize("env_id", IDS[1:])
def test_rollout_runs_the_new_ids_on_cpu(env_id):
    handle = tenvs.make(env_id, device="cpu", max_episode_steps=3)
    state, obs, reward_sum, done_count = rollout(handle, num_envs=6, n_steps=7, seed=1)
    assert obs.shape == (6, handle.cfg.obs_dim) and torch.isfinite(obs).all()
    assert torch.isfinite(reward_sum) and int(done_count) >= 12  # truncations at steps 3, 6
    again = rollout(handle, num_envs=6, n_steps=7, seed=1, frame_stack=2, reset_pool=2)
    # a wave of 6 done envs exceeds the pool of 2: the full-width path, but
    # other draws on the steps in between
    assert again[1].shape == obs.shape and int(again[3]) == int(done_count)


def test_registry_lists_the_four_ids():
    """Named for the four ids it first held: it holds every registered id."""
    assert set(IDS) <= set(tenvs.registered_ids())
    for env_id in tenvs.registered_ids():
        h = tenvs.make(env_id, device="cpu")
        assert h.device == CPU and h.env_id == env_id
        jh = jenvs.make(env_id)
        assert (jh.reset_info is None) == (h.reset_info is None)
        assert h.cfg.obs_dim == jh.cfg.obs_dim and h.cfg.action_dim == jh.cfg.action_dim
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                tenvs.make(env_id)
    with pytest.raises(KeyError):
        tenvs.make("usv-no-such-env", device="cpu")


def test_registry_equals_the_jax_registry():
    assert tenvs.registered_ids() == jenvs.registry.registered_ids()
    assert len(tenvs.registered_ids()) == 8


# config fields that end episodes within a few steps: the legacy ids have no
# time limit, a cross-track bound of 1 m ends most of their episodes at once
SHORT_EPISODES = {env_id: ({"max_ye": 1.0} if env_id.endswith("-v0") and "ca" not in env_id
                           else {"max_episode_steps": 3})
                  for env_id in ["usv-simple", "usv-asmc-simple", "usv-aitsmc-simple",
                                 "usv-asmc-ca-v0", "usv-curved-aitsmc", "usv-asmc-v0",
                                 "usv-pid-v0", "usv-asmc-ye-int-v0"]}


@pytest.mark.parametrize("reset_pool", [0, 2], ids=["full_width", "pooled"])
@pytest.mark.parametrize("env_id", sorted(SHORT_EPISODES))
def test_every_id_runs_through_batched_env(env_id, reset_pool):
    """Full-width and pooled auto-reset with ``frame_stack=5`` and
    ``sanitize=True`` over each id's (nested) state."""
    handle = tenvs.make(env_id, device="cpu", **SHORT_EPISODES[env_id])
    n, d, a = 6, handle.cfg.obs_dim, handle.cfg.action_dim
    benv = BatchedEnv(handle, n, frame_stack=5, sanitize=True, reset_pool=reset_pool)
    state, obs = benv.reset(4)
    assert obs.shape == (n, d) and state.stacked_obs.shape == (n, 5 * d)
    shapes = [tuple(leaf.shape) for leaf in tree_leaves(state.env)]
    assert all(shape[0] == n for shape in shapes)
    dones = 0
    rng = np.random.default_rng(0)
    for _ in range(7):
        action = torch.from_numpy(rng.uniform(-1, 1, (n, a)).astype(np.float32))
        state, ts = benv.step(state, action)
        dones += int(ts.done.sum())
        assert ts.obs.shape == (n, d) and torch.isfinite(ts.obs).all()
        assert not ts.info["diverged"].any()
        assert ts.info["terminal_observation"].shape == (n, d)
        # the newest frame is the step's obs; a done row's stack is refilled
        assert torch.equal(state.frames[:, -1], ts.obs)
        assert torch.equal(state.frames[ts.done, 0], ts.obs[ts.done])
    assert [tuple(leaf.shape) for leaf in tree_leaves(state.env)] == shapes
    assert dones >= n  # episodes ended and were replaced

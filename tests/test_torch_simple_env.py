"""The port's ``usv-simple`` core against ``usv_tpu.envs.simple``, on the CPU.

* The reset transform, fed the exact uniform block the JAX reset draws
  (rebuilt as ``simple.py:273-278`` does): every field, floats at atol=1e-6
  with rtol=1e-6 beside it (coordinates reach ~30 m and the path end ~115 m,
  where one float32 ulp is 1.9e-6 and 7.6e-6, and XLA's and torch's
  log/cos/sin differ by an ulp on ~5% of arguments), the mask and step count
  exactly; with and without path obstacles.
* The torch sampler, statistically at 50k draws: KS per continuous marginal,
  chi-square on the obstacle-count pmf over 15..29.
* One step from converted JAX states (B=16): obs and reward at atol=1e-5,
  flags exactly, the info dict at atol=1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

# the JAX reference's envs need flax; a card-only machine may lack it, and
# then this file (CPU parity only) skips as a whole
pytest.importorskip("flax", reason="the JAX reference (usv_tpu.envs) needs flax")

from usv_tpu.envs import simple as jsimple
from usv_tpu_torch.convert import simple_state_from_numpy
from usv_tpu_torch.envs import simple as tsimple

CPU = torch.device("cpu")
CONFIGS = {
    "default": {},
    "path_obstacles": {"path_obstacles": 3},
    "true_min": {"strict_compat_raycast": False},
    "ignore_obstacles": {"ignore_obstacles": True, "max_episode_steps": 3},
}


def _cfgs(name):
    return jsimple.SimpleEnvConfig(**CONFIGS[name]), tsimple.SimpleEnvConfig(**CONFIGS[name])


def to_numpy(state):
    """A vmapped JAX state as field name -> numpy array (the key dropped)."""
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state) if f.name != "key"}


def jax_reset_uniform(cfg, keys):
    """The block each JAX reset draws: ``uniform(split(key)[0], (n,))``."""
    n = 16 + 3 * cfg.obstacle_cap + 3 * cfg.path_obstacles
    return jax.jit(jax.vmap(
        lambda k: jax.random.uniform(jax.random.split(k)[0], (n,), jnp.float32)))(keys)


def _assert_state_close(got, want, atol):
    for name, w in want.items():
        g = getattr(got, name)
        assert tuple(g.shape) == w.shape, name
        if w.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", ["default", "path_obstacles"])
def test_reset_transform_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    keys = jax.random.split(jax.random.key(11), 256)
    # op by op (no jit): XLA's fusion would contract path_start + dir * dist
    # into an FMA, a few ulps of the ~100 m terms away from torch's rounding
    jstate, jobs, jinfo = jax.vmap(lambda k: (
        lambda s: (s, jsimple.reset_obs(jcfg, s), jsimple.reset_info(jcfg, s)))(
            jsimple.reset(jcfg, k)))(keys)
    u = torch.from_numpy(np.array(jax_reset_uniform(jcfg, keys)))
    assert u.shape[1] == tsimple.n_uniform(tcfg)
    got = tsimple.reset_from_uniform(tcfg, u)
    _assert_state_close(got, to_numpy(jstate), atol=1e-6)
    # the reset observation and info agree as well
    np.testing.assert_allclose(tsimple.reset_obs(tcfg, got).numpy(), np.asarray(jobs),
                               atol=1e-6, rtol=0)
    tinfo = tsimple.reset_info(tcfg, got)
    assert sorted(tinfo) == sorted(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_reset_transform_refills_slot_zero(monkeypatch):
    """Every random obstacle on the start point: the prune drops them all and
    slot 0 comes back at the fallback position, as in JAX (whose uniform
    draw is replaced by the same block)."""
    jcfg, tcfg = _cfgs("default")
    K = jcfg.obstacle_cap
    u = np.asarray(jax_reset_uniform(jcfg, jax.random.split(jax.random.key(3), 4))).copy()
    u[:, 0], u[:, 1] = 1.0 - 1e-7, 0.0   # box-muller r ~ 0: start at (10, 10)
    u[:, 14:14 + 2 * K] = 0.5            # every obstacle at (10, 10)

    def reset_from_block(block):
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape, dtype=None: block)
        return jsimple.reset(jcfg, jax.random.key(0))

    want_state = jax.vmap(reset_from_block)(jnp.asarray(u))
    monkeypatch.undo()
    got = tsimple.reset_from_uniform(tcfg, torch.from_numpy(u))
    assert got.obs_mask.sum(-1).tolist() == [1, 1, 1, 1]
    _assert_state_close(got, to_numpy(want_state), atol=1e-6)


def test_sampler_distributions():
    """The torch sampler at 50k draws, seed 0: each marginal against its
    closed form (KS), and the obstacle count against uniform over 15..29
    (chi-square); p > 1e-3 each."""
    cfg = tsimple.SimpleEnvConfig()
    g = torch.Generator().manual_seed(0)
    s = tsimple.reset(cfg, g, 50_000, CPU)
    np_ = lambda t: t.numpy().astype(np.float64)  # noqa: E731
    ps, pe = np_(s.path_start), np_(s.path_end)
    d = pe - ps
    ma = np_(s.max_action)
    U = stats.uniform
    marginals = {
        "path_start_x": (ps[:, 0], stats.norm(10.0, 0.5)),
        "path_start_y": (ps[:, 1], stats.norm(10.0, 0.5)),
        "heading": (np_(s.position)[:, 2], U(-np.pi, 2 * np.pi)),
        "path_angle": (np.arctan2(d[:, 1], d[:, 0]), U(-np.pi, 2 * np.pi)),
        "path_length": (np.hypot(d[:, 0], d[:, 1]), U(100.0, 10.0)),
        "target_x": (np_(s.target_position)[:, 0], U(0.0, 20.0)),
        "target_y": (np_(s.target_position)[:, 1], U(0.0, 20.0)),
        "velocity_u": (np_(s.velocity)[:, 0], U(0.0, 0.15)),
        "velocity_r": (np_(s.velocity)[:, 2], U(0.0, 0.15)),
        "max_u": (ma[:, 0], U(1.5, 1.5)),
        "max_r": (ma[:, 2], U(3.0, 3.0)),
        "reference_velocity": ((np_(s.reference_velocity) - 0.75) / (ma[:, 0] - 0.75), U(0.0, 1.0)),
        "obs_x": (np_(s.obs_xy)[:, 20, 0], U(0.0, 20.0)),
        "obs_y": (np_(s.obs_xy)[:, 20, 1], U(0.0, 20.0)),
        "obs_r": (np_(s.obs_r)[:, 20], U(0.15, 0.35)),
    }
    for name, (x, dist) in marginals.items():
        p = stats.kstest(x, dist.cdf).pvalue
        assert p > 1e-3, f"{name}: KS p={p}"

    # the drawn count n is one past the last kept slot, unless the slot
    # after it was pruned (within 0.5 m of start or target): drop those
    # ~0.4% of draws, which do not depend on n
    mask = s.obs_mask.numpy()
    oxy = s.obs_xy.numpy()
    near = (np.hypot(*(oxy - s.position.numpy()[:, None, :2]).transpose(2, 0, 1)) < 0.5) | (
        np.hypot(*(oxy - s.target_position.numpy()[:, None, :]).transpose(2, 0, 1)) < 0.5)
    last = cfg.obstacle_cap - 1 - np.argmax(mask[:, ::-1], axis=1)
    nxt = np.minimum(last + 1, cfg.obstacle_cap - 1)
    clear = ~near[np.arange(len(last)), nxt] | (last + 1 >= 29)
    n = last[clear] + 1
    counts = np.array([(n == k).sum() for k in range(15, 30)])
    assert counts.sum() == len(n) and len(n) > 49_000
    p = stats.chisquare(counts).pvalue
    assert p > 1e-3, f"obstacle count pmf: chi-square p={p} counts={counts}"


def _jax_states(jcfg, B, n_steps, seed):
    """JAX states after ``n_steps`` random steps, with envs 0-2 pressed
    against an obstacle so that termination is exercised."""
    rng = np.random.default_rng(seed)
    state = jax.jit(jax.vmap(lambda k: jsimple.reset(jcfg, k)))(
        jax.random.split(jax.random.key(seed), B))
    vstep = jax.jit(jax.vmap(lambda s, a: jsimple.step(jcfg, s, a)))
    for _ in range(n_steps):
        state, _ = vstep(state, jnp.asarray(rng.uniform(-1, 1, (B, 2)), jnp.float32))
    pos = np.asarray(state.position)
    oxy = np.asarray(state.obs_xy).copy()
    mask = np.asarray(state.obs_mask).copy()
    oxy[:3, 0] = pos[:3, :2] + np.array([0.3, 0.0], np.float32)
    mask[:3, 0] = True
    return state.replace(obs_xy=jnp.asarray(oxy), obs_mask=jnp.asarray(mask)), vstep, rng


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    B = 16
    jstate, vstep, rng = _jax_states(jcfg, B, n_steps=4, seed=5)
    for _ in range(3):
        action = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
        tstate = simple_state_from_numpy(to_numpy(jstate), CPU)
        jnew, jts = vstep(jstate, jnp.asarray(action))
        tnew, tts = tsimple.step(tcfg, tstate, torch.from_numpy(action))
        np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tts.terminated.numpy(), np.asarray(jts.terminated))
        np.testing.assert_array_equal(tts.truncated.numpy(), np.asarray(jts.truncated))
        assert sorted(tts.info) == sorted(jts.info)
        for k, v in jts.info.items():
            rtol = 1e-6 if k == "path_end" else 0
            np.testing.assert_allclose(tts.info[k].numpy(), np.asarray(v), atol=1e-5,
                                       rtol=rtol, err_msg=k)
        _assert_state_close(tnew, to_numpy(jnew), atol=1e-5)
        jstate = jnew
    if name == "ignore_obstacles":
        assert not tts.terminated.any() and tts.truncated.all()
    elif name == "default":
        assert tts.terminated[:3].all()


def test_step_without_position_update_matches_jax():
    jcfg, tcfg = _cfgs("default")
    jstate, _, rng = _jax_states(jcfg, 8, n_steps=2, seed=9)
    action = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
    _, jts = jax.jit(jax.vmap(lambda s, a: jsimple.step(jcfg, s, a, update_position=False)))(
        jstate, jnp.asarray(action))
    _, tts = tsimple.step(tcfg, simple_state_from_numpy(to_numpy(jstate), CPU),
                          torch.from_numpy(action), update_position=False)
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), atol=1e-5, rtol=0)

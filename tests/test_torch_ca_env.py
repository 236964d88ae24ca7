"""The port's ``usv-asmc-ca-v0`` against ``usv_tpu.envs.asmc_ca``, on the CPU.

* ``build_core`` fed the uniform block the JAX reset draws
  (``uniform(split(key)[0], (6 + 3K,))``) against ``_build_core``: floats at
  atol=1e-6 with rtol=1e-6, the mask and the counters exactly; with and
  without obstacles. Obstacle centres at atol=5e-6: a centre is the scene's
  midpoint plus ten times a Box-Muller normal, terms of up to ~40 m (one
  float32 ulp: 3.8e-6) that may cancel, and XLA's and PyTorch's log, cos and
  sin differ by an ulp on ~5% of arguments. Then the whole reset (the
  scene plus its bootstrap step with [-1, 0]) and its reset obs at atol=1e-5.
* One step from converted JAX states (B=32, warmed by a few JAX steps), JAX
  op by op (``jax.disable_jit()``): obs and reward at atol=1e-5, flags
  exactly, every info key and state leaf at atol=1e-5 with rtol=1e-5, but
  ``o_dot_dot_last`` at 2e-4 (400 times the last bit of a ~3 rad heading).
  The JAX env reaches its ray-cast through ``sensor_raycast``'s XLA form on
  the CPU, as its own tests do; the port takes its plain form.
* ``filter_action=True`` with a different window index in every env,
  ``debug_history=True`` (histories are ``(B, n_substeps, ...)``), and each
  rung of the termination ladder on constructed states.
* A 15-step run, each side on its own against the jitted JAX step: obs and
  reward within 2e-4, flags equal (the bound is loose for the reasons
  ``tests/test_torch_hydro_envs.py`` gives).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu.envs) needs flax")

from usv_tpu.envs import asmc_ca as jca
from usv_tpu_torch.convert import ca_state_from_numpy
from usv_tpu_torch.envs import asmc_ca as tca

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)
LEAF_ATOL = {"o_dot_dot_last": 2e-4}


def to_numpy(state):
    """A vmapped JAX state as a (nested) dict of numpy arrays, keys dropped."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name != "key":
            out[f.name] = to_numpy(v) if dataclasses.is_dataclass(v) else np.array(v)
    return out


def assert_state_close(got, want, atol, rtol, path="", leaf_atol=None):
    for name, w in want.items():
        g = getattr(got, name)
        if isinstance(w, dict):
            assert_state_close(g, w, atol, rtol, path + name + ".", leaf_atol)
            continue
        assert tuple(g.shape) == w.shape, path + name
        if w.dtype.kind in "bi":
            assert g.dtype in (torch.bool, torch.int32), path + name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path + name)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=(leaf_atol or {}).get(name, atol),
                                       rtol=rtol, err_msg=path + name)


def assert_info_close(tinfo, jinfo, **tol):
    assert sorted(tinfo) == sorted(jinfo)
    for k, v in jinfo.items():
        if isinstance(v, dict):
            assert_info_close(tinfo[k], v, **tol)
        elif np.asarray(v).dtype == np.bool_:
            np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(v), err_msg=k)
        else:
            np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(v), err_msg=k, **tol)


def assert_timestep_close(tts, jts, atol, info_tol=None):
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs), atol=atol, rtol=0)
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), atol=atol, rtol=1e-6)
    np.testing.assert_array_equal(tts.terminated.numpy(), np.asarray(jts.terminated))
    np.testing.assert_array_equal(tts.truncated.numpy(), np.asarray(jts.truncated))
    if info_tol is not None:
        assert_info_close(tts.info, jts.info, **info_tol)


def jax_reset_uniform(cfg, keys):
    n = 6 + 3 * cfg.obstacle_cap
    return np.array(jax.vmap(
        lambda k: jax.random.uniform(jax.random.split(k)[0], (n,), jnp.float32))(keys))


@pytest.mark.parametrize("place_obstacles", [True, False])
def test_reset_transform_matches_jax(place_obstacles):
    jcfg = jca.CaEnvConfig(place_obstacles=place_obstacles)
    tcfg = tca.CaEnvConfig(place_obstacles=place_obstacles)
    keys = jax.random.split(jax.random.key(31), 128)
    u = torch.from_numpy(jax_reset_uniform(jcfg, keys))
    assert u.shape[1] == tca.n_uniform(tcfg) == 54

    core = tca.build_core(tcfg, u)
    jcore = jax.vmap(lambda k: jca._build_core(jcfg, k))(keys)
    assert_state_close(core, to_numpy(jcore), atol=1e-6, rtol=1e-6, leaf_atol={"obs_xy": 5e-6})
    counts = core.obs_mask.sum(-1)
    if place_obstacles:
        assert counts.max() <= 9 and counts.float().mean() > 2  # floored 2..9, then pruned
    else:
        assert counts.sum() == 0

    # the whole reset: the scene, then one real step with [-1, 0]
    got = tca.reset_from_uniform(tcfg, u)
    with jax.disable_jit():
        want = jax.vmap(lambda k: jca.reset(jcfg, k))(keys[:32])
    assert_state_close(dataclasses.replace(got, **{
        f.name: _rows(getattr(got, f.name), 32) for f in dataclasses.fields(got)}),
        to_numpy(want), leaf_atol=LEAF_ATOL, **TOL)
    assert (got.step_count == 0).all() and (got.perturb_step == 0).all()
    assert torch.equal(tca.reset_obs(tcfg, got), got.state_vec)
    assert got.state_vec.abs().sum() > 0 and (got.dyn.vel[:, 0].abs() > 0).all()
    assert (got.action_history == torch.tensor([-1.0, 0.0])).all()
    drawn = tca.reset(tcfg, torch.Generator().manual_seed(0), 5, CPU)
    assert drawn.state_vec.shape == (5, 23)


def _rows(value, n):
    if dataclasses.is_dataclass(value):
        return dataclasses.replace(value, **{
            f.name: _rows(getattr(value, f.name), n) for f in dataclasses.fields(value)})
    return value[:n]


def test_build_core_rejects_a_wrong_block():
    with pytest.raises(ValueError, match="uniform block"):
        tca.build_core(tca.CaEnvConfig(), torch.zeros(4, 53))


def _warm_jax_states(jcfg, B, n_steps, seed):
    rng = np.random.default_rng(seed)
    state = jax.jit(jax.vmap(lambda k: jca.reset(jcfg, k)))(
        jax.random.split(jax.random.key(seed), B))
    vstep = jax.jit(jax.vmap(lambda s, a: jca.step(jcfg, s, a)))
    for _ in range(n_steps):
        state, _ = vstep(state, jnp.asarray(_actions(rng, B)))
    return state, vstep, rng


def _actions(rng, B):
    return rng.uniform(-1, 1, (B, 2)).astype(np.float32)


@pytest.mark.parametrize("options", [
    {}, {"strict_compat_raycast": False}, {"filter_action": True}, {"debug_history": True}],
    ids=["default", "true_min", "filter_action", "debug_history"])
def test_step_matches_jax(options):
    jcfg, tcfg = jca.CaEnvConfig(**options), tca.CaEnvConfig(**options)
    B = 32
    jstate, _, rng = _warm_jax_states(jcfg, B, n_steps=3, seed=13)
    if options.get("filter_action"):
        # every env at its own slot of the window, as after staggered resets
        jstate = jstate.replace(filter_window_i=jnp.arange(B, dtype=jnp.int32) % 5)
    for _ in range(2):
        action = _actions(rng, B)
        tstate = ca_state_from_numpy(to_numpy(jstate), CPU)
        with jax.disable_jit():
            jnew, jts = jax.vmap(lambda s, a: jca.step(jcfg, s, a))(jstate, jnp.asarray(action))
        tnew, tts = tca.step(tcfg, tstate, torch.from_numpy(action))
        assert_timestep_close(tts, jts, atol=1e-5, info_tol=TOL)
        assert_state_close(tnew, to_numpy(jnew), leaf_atol=LEAF_ATOL, **TOL)
        jstate = jnew
    assert (tts.obs[:, 7:] < 1.0).any()  # some ray sees an obstacle
    if options.get("debug_history"):
        assert tts.info["model_history"]["pose"].shape == (B, tcfg.n_substeps, 3)
        assert tts.info["controller_history"]["Tz"].shape == (B, tcfg.n_substeps)
        assert torch.equal(tts.info["controller_history"]["left_thruster"][:, -1],
                           tts.info["left_thruster"])
    if options.get("filter_action"):
        assert len(set(tnew.filter_window_i.tolist())) == 5
        assert not torch.equal(tts.info["action"][:, 0], torch.from_numpy(action[:, 0]))


def test_termination_ladder_matches_jax():
    """One env per rung: none, arrived, collision, far (reward - 100), out of
    bounds (both flags), the time limit, and an env with no obstacle beside an
    obstacle-free collision candidate."""
    jcfg, tcfg = jca.CaEnvConfig(), tca.CaEnvConfig()
    B = 7
    jstate, _, rng = _warm_jax_states(jcfg, B, n_steps=2, seed=17)
    s = to_numpy(jstate)
    pose = s["dyn"]["pose"]
    pose[:, :2] = np.array([5.0, 0.0], np.float32)
    s["target_point"][:] = np.array([15.0, 2.0], np.float32)
    s["obs_mask"][:] = False
    s["target_point"][1] = pose[1, :2] + np.array([0.5, 0.5], np.float32)   # arrived
    s["obs_xy"][2, 0] = pose[2, :2] + np.array([0.3, 0.0], np.float32)      # collision
    s["obs_r"][2, 0], s["obs_mask"][2, 0] = 1.0, True
    s["target_point"][3] = pose[3, :2] + np.array([45.0, 0.0], np.float32)  # far
    pose[4, 0] = 101.0                                                      # out of bounds
    s["target_point"][4] = pose[4, :2] + np.array([10.0, 0.0], np.float32)
    s["step_count"][5] = jcfg.max_episode_steps - 1                         # time limit
    s["obs_xy"][6, 0] = pose[6, :2]                                         # masked: no collision
    key = jstate.key
    jstate = jax.tree.map(jnp.asarray, jca.CaEnvState(
        key=key, ctrl=type(jstate.ctrl)(**s["ctrl"]), dyn=type(jstate.dyn)(**s["dyn"]),
        **{k: v for k, v in s.items() if k not in ("ctrl", "dyn")}))
    action = np.zeros((B, 2), np.float32)
    _, jts = jax.vmap(lambda st, a: jca.step(jcfg, st, a))(jstate, jnp.asarray(action))
    _, tts = tca.step(tcfg, ca_state_from_numpy(s, CPU), torch.from_numpy(action))
    assert_timestep_close(tts, jts, atol=1e-5, info_tol=dict(atol=1e-4, rtol=1e-5))
    assert tts.terminated.tolist() == [False, True, False, True, True, False, False]
    assert tts.truncated.tolist() == [False, False, True, False, True, True, False]
    assert tts.info["arrived"].tolist() == [False, True, False, False, False, False, False]
    assert tts.info["collision"].tolist() == [False, False, True, False, False, False, False]
    assert float(tts.reward[3]) < -100.0 < float(tts.reward[0])


def test_multi_step_run_stays_close_to_jax():
    jcfg, tcfg = jca.CaEnvConfig(), tca.CaEnvConfig()
    B, T = 32, 15
    jstate, vstep, rng = _warm_jax_states(jcfg, B, n_steps=0, seed=19)
    tstate = ca_state_from_numpy(to_numpy(jstate), CPU)
    start = np.asarray(jstate.dyn.pose)
    for _ in range(T):
        # a setpoint that holds for a few steps, so that the boats get under way
        action = np.stack([rng.uniform(0.2, 1.0, B), rng.uniform(-0.3, 0.3, B)], 1).astype(np.float32)
        jstate, jts = vstep(jstate, jnp.asarray(action))
        tstate, tts = tca.step(tcfg, tstate, torch.from_numpy(action))
        assert_timestep_close(tts, jts, atol=2e-4)
    moved = np.hypot(*(np.asarray(jstate.dyn.pose) - start)[:, :2].T)
    assert moved.mean() > 0.05  # under way: 15 steps are 1.5 s
    assert int(tstate.step_count[0]) == T and int(tstate.perturb_step[0]) == T


def test_config_carries_the_jax_fields():
    jcfg, tcfg = jca.CaEnvConfig(), tca.CaEnvConfig()
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tf = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    assert jf == tf
    assert (tcfg.obs_dim, tcfg.action_dim) == (jcfg.obs_dim, jcfg.action_dim) == (23, 2)
    assert tcfg.action_low == jcfg.action_low and tcfg.action_high == jcfg.action_high

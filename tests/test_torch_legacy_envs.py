"""The port's legacy ids (``usv-asmc-v0``, ``usv-pid-v0``,
``usv-asmc-ye-int-v0``) against ``usv_tpu.envs.legacy``, on the CPU.

* The reset transform fed the seven uniforms the JAX reset draws from
  ``jax.random.split(key, 8)``: every field at atol=1e-6 with rtol=1e-6.
* One step of each id from converted JAX states (B=16), JAX op by op (no
  ``jit``): obs and reward at atol=1e-5, flags exactly, every info key and
  state leaf at atol=1e-5 with rtol=1e-5 — from warmed states (thrusts
  unsaturated), from rest under a large heading demand (thrusts saturated at
  -30 and 36.5), with a done env, with ``psi`` carried across +-pi, and for
  the ye-int env with a cross-track sign change.
* 200-step runs, each side on its own against the jitted JAX step: obs and
  reward within 2e-4 at every step (loose for the reasons
  ``tests/test_torch_hydro_envs.py`` gives).
* The ye-int integrator by hand; the legacy quirks (frozen ``e_u_last``,
  ``truncated`` always false, reward -1 on done, the action's two shapes,
  no write into the caller's pose).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu.envs) needs flax")

from usv_tpu.envs import legacy as jlg
from usv_tpu_torch.convert import legacy_state_from_numpy
from usv_tpu_torch.envs import legacy as tlg

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)

# function suffix -> (JAX config, the port's config, start box half-width, speed range)
IDS = {
    "asmc": (jlg.LegacyAsmcConfig, tlg.LegacyAsmcConfig, 2.5, (1.4, 2.4)),
    "pid": (jlg.LegacyPidConfig, tlg.LegacyPidConfig, 2.5, (0.4, 1.4)),
    "ye_int": (jlg.LegacyYeIntConfig, tlg.LegacyYeIntConfig, 5.0, (0.4, 1.4)),
}


def _fns(name, **overrides):
    jcls, tcls, _, _ = IDS[name]
    return (getattr(jlg, f"reset_{name}"), getattr(jlg, f"step_{name}"), jcls(**overrides),
            getattr(tlg, f"reset_from_uniform_{name}"), getattr(tlg, f"step_{name}"),
            tcls(**overrides))


def to_numpy(state):
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name != "key":
            out[f.name] = to_numpy(v) if dataclasses.is_dataclass(v) else np.array(v)
    return out


def from_numpy(jstate, leaves):
    def build(template, d):
        kw = {}
        for f in dataclasses.fields(template):
            v = getattr(template, f.name)
            if f.name == "key":
                kw[f.name] = v
            elif dataclasses.is_dataclass(v):
                kw[f.name] = build(v, d[f.name])
            else:
                kw[f.name] = jnp.asarray(d[f.name])
        return type(template)(**kw)

    return build(jstate, leaves)


def assert_state_close(got, want, atol, rtol, path=""):
    for name, w in want.items():
        g = getattr(got, name)
        if isinstance(w, dict):
            assert_state_close(g, w, atol, rtol, path + name + ".")
            continue
        assert tuple(g.shape) == w.shape, path + name
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=rtol, err_msg=path + name)


def assert_timestep_close(tts, jts, atol, info_tol=None):
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs), atol=atol, rtol=0)
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), atol=atol, rtol=1e-6)
    np.testing.assert_array_equal(tts.terminated.numpy(), np.asarray(jts.terminated))
    np.testing.assert_array_equal(tts.truncated.numpy(), np.asarray(jts.truncated))
    if info_tol is not None:
        assert sorted(tts.info) == sorted(jts.info)
        for k, v in jts.info.items():
            np.testing.assert_allclose(tts.info[k].numpy(), np.asarray(v), err_msg=k, **info_tol)


def jax_reset_uniform(keys):
    """The seven U[0, 1) draws behind ``_legacy_reset``'s scaled ones."""
    return np.array(jax.vmap(lambda k: jnp.stack(
        [jax.random.uniform(kk) for kk in jax.random.split(k, 8)[:7]]))(keys))


@pytest.mark.parametrize("name", sorted(IDS))
def test_reset_transform_matches_jax(name):
    jreset, _, jcfg, treset, _, tcfg = _fns(name)
    keys = jax.random.split(jax.random.key(51), 256)
    want = jax.vmap(lambda k: jreset(jcfg, k))(keys)
    u = torch.from_numpy(jax_reset_uniform(keys))
    assert u.shape == (256, tlg.n_uniform(tcfg)) == (256, 7)
    got = treset(tcfg, u)
    assert_state_close(got, to_numpy(want), atol=1e-6, rtol=1e-6)
    _, _, pos_range, (v_lo, v_hi) = IDS[name]
    assert got.dyn.pose[:, :2].abs().max() <= pos_range
    assert v_lo <= got.target[:, 2].min() and got.target[:, 2].max() <= v_hi
    assert (got.target[:, 3] == 0).all()  # y_d = y_0: the path runs along +x
    assert torch.equal(getattr(tlg, f"reset_obs_{name}")(tcfg, got), got.state_vec)
    with pytest.raises(ValueError, match="uniform block"):
        treset(tcfg, torch.zeros(3, 8))
    drawn = getattr(tlg, f"reset_{name}")(tcfg, torch.Generator().manual_seed(0), 5, CPU)
    assert drawn.state_vec.shape == (5, 6) and drawn.ka_u.shape == (5,)


def _actions(rng, B, scale=0.8):
    return rng.uniform(-scale, scale, (B, 1)).astype(np.float32)


def _warm_jax_states(name, B, n_steps, seed, **overrides):
    jreset, jstep, jcfg, _, _, _ = _fns(name, **overrides)
    rng = np.random.default_rng(seed)
    state = jax.vmap(lambda k: jreset(jcfg, k))(jax.random.split(jax.random.key(seed), B))
    vstep = jax.jit(jax.vmap(lambda s, a: jstep(jcfg, s, a)))
    for _ in range(n_steps):
        state, _ = vstep(state, jnp.asarray(_actions(rng, B)))
    return state, vstep, rng


def _one_step_both(name, jstate, action, **overrides):
    _, jstep, jcfg, _, tstep, tcfg = _fns(name, **overrides)
    tstate = legacy_state_from_numpy(to_numpy(jstate), CPU)
    before = tstate.dyn.pose.clone()
    jnew, jts = jax.vmap(lambda s, a: jstep(jcfg, s, a))(jstate, jnp.asarray(action))
    tnew, tts = tstep(tcfg, tstate, torch.from_numpy(action))
    assert_timestep_close(tts, jts, atol=1e-5, info_tol=TOL)
    assert_state_close(tnew, to_numpy(jnew), **TOL)
    assert torch.equal(tstate.dyn.pose, before)  # the caller's pose is not written into
    return tstate, tnew, tts


@pytest.mark.parametrize("name", sorted(IDS))
def test_step_matches_jax_unsaturated(name):
    B = 16
    # 150 steps (1.5 s) bring the thrusts off their limits
    jstate, _, rng = _warm_jax_states(name, B, n_steps=150, seed=53)
    _, tnew, tts = _one_step_both(name, jstate, _actions(rng, B, 0.05))
    thrust = torch.stack([tts.info["tport"], tts.info["tstbd"]])
    assert ((thrust > -30.0) & (thrust < 36.5)).any()
    assert not tts.truncated.any() and tts.truncated.dtype == torch.bool
    assert (tnew.e_u_int != 0).all()


@pytest.mark.parametrize("name", sorted(IDS))
def test_step_matches_jax_saturated_from_rest(name):
    B = 16
    jstate, _, rng = _warm_jax_states(name, B, n_steps=0, seed=57)
    action = np.where(np.arange(B)[:, None] % 2 == 0, 1.5, -1.5).astype(np.float32)
    _, tnew, tts = _one_step_both(name, jstate, action)
    thrust = torch.stack([tts.info["tport"], tts.info["tstbd"]])
    # asymmetric saturation: both limits are live from rest (the PID's speed
    # derivative term e_u / dt keeps both thrusters forward: upper limit only)
    assert (thrust == 36.5).any() and ((thrust == -30.0).any() or name == "pid")
    assert thrust.min() >= -30.0 and thrust.max() <= 36.5
    if name != "pid":
        # the gain law's else-branch is the constant kmin: ka grows from 0 by
        # 0.5 * dt * kmin on the first step
        torch.testing.assert_close(tnew.ka_u, torch.full((B,), 0.5 * 0.01 * 0.05))
        torch.testing.assert_close(tnew.ka_psi, torch.full((B,), 0.5 * 0.01 * 0.2))
    # the (B,) action form is the (B, 1) form
    _, _, _, _, tstep, tcfg = _fns(name)
    tstate = legacy_state_from_numpy(to_numpy(jstate), CPU)
    flat = tstep(tcfg, tstate, torch.from_numpy(action[:, 0]))[1]
    assert torch.equal(flat.obs, tts.obs) and torch.equal(flat.reward, tts.reward)


@pytest.mark.parametrize("name", sorted(IDS))
def test_step_matches_jax_done_and_psi_across_pi(name):
    B = 16
    jstate, _, rng = _warm_jax_states(name, B, n_steps=20, seed=59)
    s = to_numpy(jstate)
    pose = s["dyn"]["pose"]
    pose[0, 1] = s["target"][0, 1] + 10.5        # |ye| > 10
    pose[1, 0] = 30.5                            # |x| > 30: done for usv-asmc-v0 only
    pose[2, 0] = -10.5                           # x < min_x: done for the other two
    pose[3, 2] = np.pi - 1e-4                    # the step carries psi across +pi
    s["dyn"]["vel"][3, 2] = 0.8
    pose[4, 2] = -np.pi + 1e-4                   # and across -pi
    s["dyn"]["vel"][4, 2] = -0.8
    pose[5, 2] = 1.2                             # psi_ak beyond pi/2 with the action: reward_ak
    s["dyn"]["pose"][6, 2] = 2.9                 # e_psi wraps: psi_d - psi below -pi
    jstate = from_numpy(jstate, s)
    action = _actions(rng, B, 0.3)
    action[6] = -1.5
    _, tnew, tts = _one_step_both(name, jstate, action)
    want_done = [True, name == "asmc", name != "asmc"] + [False] * (B - 3)
    assert tts.terminated.tolist() == want_done
    assert (tts.reward[tts.terminated] == -1.0).all()
    assert (tts.reward[~tts.terminated] != -1.0).all()
    assert not tts.truncated.any()
    # wrap-once leaves psi in (-pi, pi]
    assert float(tnew.dyn.pose[3, 2]) < 0 < float(tnew.dyn.pose[4, 2])
    assert tnew.dyn.pose[:, 2].abs().max() <= np.pi


def test_ye_int_sign_change_and_integrator():
    name, B = "ye_int", 8
    jstate, _, rng = _warm_jax_states(name, B, n_steps=30, seed=61)
    s = to_numpy(jstate)
    y0 = s["target"][:, 1]
    s["dyn"]["pose"][:, 1] = y0 + np.array([0.5, -0.5, 0.5, -0.5, 2.0, -2.0, 1e-3, 0.0], np.float32)
    s["dyn"]["vel"][:] = 0
    s["dyn"]["accel_last"][:] = 0
    s["dyn"]["eta_dot_last"][:] = 0
    # previous ye of the same sign (integrates on), of the other sign (resets),
    # and zero (sign(0) = 0 differs from any sign: resets, as on a first step)
    s["ye_last"][:] = np.array([0.4, -0.4, -0.4, 0.4, 0.0, 0.0, 1e-3, 0.0], np.float32)
    s["ye_int"][:] = 3.0
    jstate = from_numpy(jstate, s)
    tstate, tnew, tts = _one_step_both(name, jstate, np.zeros((B, 1), np.float32))
    ye = tts.info["ye"]
    dt, k_i = 0.01, 0.001
    kept = torch.tensor([True, True, False, False, False, False, True, True])
    # the NON-halved trapezoid: dt * (ye + ye_last), on top of the kept or reset integral
    want = dt * (ye + tstate.ye_last) + torch.where(kept, 3.0, 0.0)
    torch.testing.assert_close(tnew.ye_int, want, atol=1e-6, rtol=0)
    assert torch.equal(tnew.ye_last, ye)
    torch.testing.assert_close(tts.obs[:, 3], ye + k_i * tnew.ye_int, atol=1e-6, rtol=0)
    # the other two ids leave the extension at rest
    for other in ("asmc", "pid"):
        jo, _, _ = _warm_jax_states(other, 4, n_steps=3, seed=63)
        assert not np.asarray(jo.ye_int).any() and not np.asarray(jo.ye_last).any()
        _, tn, tt = _one_step_both(other, jo, np.zeros((4, 1), np.float32))
        assert not tn.ye_int.any() and not tn.ye_last.any()
        assert torch.equal(tt.obs[:, 3], tt.info["ye"])


@pytest.mark.parametrize("name", sorted(IDS))
def test_200_step_run_stays_close_to_jax(name):
    B, T = 16, 200
    jstate, vstep, rng = _warm_jax_states(name, B, n_steps=0, seed=67)
    _, _, _, _, tstep, tcfg = _fns(name)
    tstate = legacy_state_from_numpy(to_numpy(jstate), CPU)
    action = _actions(rng, B, 0.5)
    worst = 0.0
    for t in range(T):
        if t % 25 == 0:  # a heading demand that holds for a quarter second
            action = _actions(rng, B, 0.5)
        jstate, jts = vstep(jstate, jnp.asarray(action))
        tstate, tts = tstep(tcfg, tstate, torch.from_numpy(action))
        assert_timestep_close(tts, jts, atol=2e-4)
        worst = max(worst, float(np.abs(tts.obs.numpy() - np.asarray(jts.obs)).max()))
    assert float(np.asarray(jstate.dyn.vel)[:, 0].mean()) > 0.2  # under way after 2 s
    assert worst > 0  # two implementations, not one: float32 rounding differs somewhere


def test_reward_forms():
    """The asmc/pid reward drops the action term beyond pi/2 and has the
    near-path sigma branch; the ye-int reward has neither."""
    cfg = tlg.LegacyAsmcConfig()
    jcfg = jlg.LegacyAsmcConfig()
    ye = torch.tensor([0.2, 3.0, 0.2, 3.0])
    psi = torch.tensor([0.3, 0.3, 2.0, -2.0])
    adot = torch.tensor([10.0, -40.0, 10.0, 0.0])
    for mode in (False, True):
        got = tlg._reward(cfg, ye, psi, adot, mode)
        want = jlg._reward(jcfg, jnp.asarray(ye.numpy()), jnp.asarray(psi.numpy()),
                           jnp.asarray(adot.numpy()), mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    assert cfg.c_action == jcfg.c_action
    plain, ye_int = tlg._reward(cfg, ye, psi, adot, False), tlg._reward(cfg, ye, psi, adot, True)
    assert float(plain[0]) > float(ye_int[0])   # exp(-k ye^2 / sigma) > exp(-k ye) at ye = 0.2
    assert float(plain[1]) == float(ye_int[1])  # far from the path: one form
    assert float(plain[3]) == float(ye_int[3])  # no action rate: the action term is 0 either way
    assert float(plain[2]) > float(ye_int[2])   # beyond pi/2 the ye-int form keeps the action term


def test_config_carries_the_jax_fields():
    for name, (jcls, tcls, _, _) in IDS.items():
        jcfg, tcfg = jcls(), tcls()
        jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
        tf = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
        assert jf == tf, name
        assert (tcfg.obs_dim, tcfg.action_dim) == (jcfg.obs_dim, jcfg.action_dim) == (6, 1)
        assert tcfg.action_low == jcfg.action_low and tcfg.action_high == jcfg.action_high

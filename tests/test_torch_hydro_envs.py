"""The port's ``usv-asmc-simple`` and ``usv-aitsmc-simple`` against
``usv_tpu.envs.simple_asmc`` and ``simple_aitsmc``, on the CPU.

* The reset transform, fed the uniform block the JAX reset draws
  (``uniform(split(key)[0], (16 + 3K,))``): every field at atol=1e-6 with
  rtol=1e-6 (coordinates reach ~115 m), masks and counters exactly; the reset
  obs and info as well.
* One step from converted JAX states (B=16, warmed by a few JAX steps), JAX
  op by op (``jax.disable_jit()``, so its scan runs as a loop and nothing is
  contracted into an FMA): obs and reward at atol=1e-5, flags exactly, every
  info key and every state leaf at atol=1e-5 with rtol=1e-5 (thrusts reach
  ~30 and positions ~100 m), but the ASMC's ``o_dot_dot_last`` at 2e-4: it is
  ``(psi_d - psi_d_last) / dt * f1 * f2``, 400 times the last bit of a
  heading of ~3 rad (2.4e-7).
* A 12-step run, each side evolving on its own against the jitted JAX step:
  obs and reward within 2e-4 at every step, flags equal. The drift bound is
  loose where the single step is tight because XLA fuses the 20 (or 5)
  substeps under ``jit`` and contracts FMAs, and the sliding-mode gain law
  (``sign(|sigma| - mu)``) turns a last-bit difference into a 1e-3 step of
  ``ka`` when an env sits on its dead-zone edge.
* Options: ``double_integrate_compat=False``; a non-zero ``perturb_fn``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu.envs) needs flax")

from usv_tpu.envs import simple_aitsmc as jait
from usv_tpu.envs import simple_asmc as jasmc
from usv_tpu_torch import convert
from usv_tpu_torch.envs import simple_aitsmc as tait
from usv_tpu_torch.envs import simple_asmc as tasmc

CPU = torch.device("cpu")


def _jax_perturb(step):
    s = step.astype(jnp.float32)
    return jnp.stack([2.0 * jnp.sin(0.3 * s), 1.5 * jnp.cos(0.2 * s), 0.2 * jnp.sin(0.1 * s)])


def _torch_perturb(step):
    s = step.to(torch.float32)
    return torch.stack([2.0 * torch.sin(0.3 * s), 1.5 * torch.cos(0.2 * s),
                        0.2 * torch.sin(0.1 * s)], dim=-1)


FAMILIES = {
    "asmc": (jasmc, tasmc, jasmc.SimpleAsmcEnvConfig, tasmc.SimpleAsmcEnvConfig,
             convert.simple_asmc_state_from_numpy, {}, {}),
    "asmc_clean": (jasmc, tasmc, jasmc.SimpleAsmcEnvConfig, tasmc.SimpleAsmcEnvConfig,
                   convert.simple_asmc_state_from_numpy,
                   {"double_integrate_compat": False}, {"double_integrate_compat": False}),
    "aitsmc": (jait, tait, jait.SimpleAitsmcEnvConfig, tait.SimpleAitsmcEnvConfig,
               convert.simple_aitsmc_state_from_numpy, {}, {}),
    "aitsmc_perturbed": (jait, tait, jait.SimpleAitsmcEnvConfig, tait.SimpleAitsmcEnvConfig,
                         convert.simple_aitsmc_state_from_numpy,
                         {"perturb_fn": _jax_perturb}, {"perturb_fn": _torch_perturb}),
}


def _family(name, **overrides):
    jmod, tmod, jcls, tcls, conv, jkw, tkw = FAMILIES[name]
    return jmod, tmod, jcls(**jkw, **overrides), tcls(**tkw, **overrides), conv


def to_numpy(state):
    """A vmapped JAX state as a (nested) dict of numpy arrays, keys dropped."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name != "key":
            out[f.name] = to_numpy(v) if dataclasses.is_dataclass(v) else np.asarray(v)
    return out


def assert_state_close(got, want, atol, rtol, path="", leaf_atol=None):
    """The port's (nested) state against ``to_numpy`` of the JAX one: floats
    within the tolerance (``leaf_atol`` overrides it by leaf name), bool and
    int leaves exactly."""
    for name, w in want.items():
        g = getattr(got, name)
        if isinstance(w, dict):
            assert_state_close(g, w, atol, rtol, path + name + ".", leaf_atol)
            continue
        atol = (leaf_atol or {}).get(name, atol)
        assert tuple(g.shape) == w.shape, path + name
        if w.dtype.kind in "bi":
            assert g.dtype in (torch.bool, torch.int32), path + name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path + name)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=rtol, err_msg=path + name)


def jax_reset_uniform(cfg, keys):
    n = 16 + 3 * cfg.obstacle_cap + 3 * cfg.path_obstacles
    return np.array(jax.vmap(
        lambda k: jax.random.uniform(jax.random.split(k)[0], (n,), jnp.float32))(keys))


@pytest.mark.parametrize("name", ["asmc", "aitsmc"])
def test_reset_transform_matches_jax(name):
    jmod, tmod, jcfg, tcfg, _ = _family(name)
    keys = jax.random.split(jax.random.key(21), 64)
    jstate, jobs, jinfo = jax.vmap(lambda k: (
        lambda s: (s, jmod.reset_obs(jcfg, s), jmod.reset_info(jcfg, s)))(jmod.reset(jcfg, k)))(keys)
    u = torch.from_numpy(jax_reset_uniform(jcfg, keys))
    assert u.shape[1] == tmod.n_uniform(tcfg)
    got = tmod.reset_from_uniform(tcfg, u)
    assert_state_close(got, to_numpy(jstate), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tmod.reset_obs(tcfg, got).numpy(), np.asarray(jobs), atol=1e-6, rtol=0)
    tinfo = tmod.reset_info(tcfg, got)
    assert sorted(tinfo) == sorted(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), atol=1e-6, rtol=1e-6,
                                   err_msg=k)
    # the generator path draws the same shapes
    drawn = tmod.reset(tcfg, torch.Generator().manual_seed(0), 5, CPU)
    assert drawn.base.position.shape == (5, 3) and drawn.ctrl.ka_u.shape == (5,)


def _warm_jax_states(jmod, jcfg, B, n_steps, seed):
    rng = np.random.default_rng(seed)
    state = jax.vmap(lambda k: jmod.reset(jcfg, k))(jax.random.split(jax.random.key(seed), B))
    vstep = jax.jit(jax.vmap(lambda s, a: jmod.step(jcfg, s, a)))
    for _ in range(n_steps):
        state, _ = vstep(state, jnp.asarray(_actions(rng, B)))
    return state, vstep, rng


def _actions(rng, B):
    """(u_d, heading offset) or (u, r) setpoints of moderate size."""
    return np.stack([rng.uniform(0.2, 1.0, B), rng.uniform(-0.6, 0.6, B)], 1).astype(np.float32)


def _assert_timestep_close(tts, jts, atol, rtol=0.0, info_tol=None):
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs), atol=atol, rtol=rtol)
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), atol=atol, rtol=rtol)
    np.testing.assert_array_equal(tts.terminated.numpy(), np.asarray(jts.terminated))
    np.testing.assert_array_equal(tts.truncated.numpy(), np.asarray(jts.truncated))
    if info_tol is not None:
        assert sorted(tts.info) == sorted(jts.info)
        for k, v in jts.info.items():
            np.testing.assert_allclose(tts.info[k].numpy(), np.asarray(v), err_msg=k, **info_tol)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_step_matches_jax(name):
    jmod, tmod, jcfg, tcfg, conv = _family(name)
    B = 16
    jstate, _, rng = _warm_jax_states(jmod, jcfg, B, n_steps=3, seed=7)
    action = _actions(rng, B)
    tstate = conv(to_numpy(jstate), CPU)
    with jax.disable_jit():
        jnew, jts = jax.vmap(lambda s, a: jmod.step(jcfg, s, a))(jstate, jnp.asarray(action))
    tnew, tts = tmod.step(tcfg, tstate, torch.from_numpy(action))
    tol = dict(atol=1e-5, rtol=1e-5)
    _assert_timestep_close(tts, jts, atol=1e-5, info_tol=tol)
    assert_state_close(tnew, to_numpy(jnew), leaf_atol={"o_dot_dot_last": 2e-4}, **tol)
    if name.startswith("aitsmc"):
        assert (tnew.base.max_action == 1.0).all() and (tnew.base.reference_velocity == 0.5).all()
        assert torch.equal(tnew.base.last_action[:, 0], tts.info["setpoint_u"])
        assert (tnew.base.last_action[:, 1] == 0).all()
        assert torch.equal(tnew.model_vel, tnew.base.velocity)
        assert (tnew.perturb_step == tstate.perturb_step + 1).all()
        assert bool(tts.info["perturb"].any()) == (name == "aitsmc_perturbed")


@pytest.mark.parametrize("name", ["asmc", "aitsmc_perturbed"])
def test_multi_step_run_stays_close_to_jax(name):
    jmod, tmod, jcfg, tcfg, conv = _family(name)
    B, T = 16, 12
    jstate, vstep, rng = _warm_jax_states(jmod, jcfg, B, n_steps=0, seed=9)
    tstate = conv(to_numpy(jstate), CPU)
    start = np.asarray(jstate.base.position)
    for _ in range(T):
        action = _actions(rng, B)
        jstate, jts = vstep(jstate, jnp.asarray(action))
        tstate, tts = tmod.step(tcfg, tstate, torch.from_numpy(action))
        _assert_timestep_close(tts, jts, atol=2e-4)
    moved = np.hypot(*(np.asarray(jstate.base.position) - start)[:, :2].T)
    assert moved.mean() > 0.01  # under way: 12 steps are 2.4 s (ASMC) or 0.6 s (AITSMC)


def test_config_carries_the_jax_fields():
    for name in ("asmc", "aitsmc"):
        _, _, jcfg, tcfg, _ = _family(name)
        jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
        tf = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
        assert sorted(jf) == sorted(tf)
        for k, v in jf.items():
            if not callable(v):
                assert tf[k] == v, k
        assert tcfg.obs_dim == jcfg.obs_dim and tcfg.action_dim == jcfg.action_dim
    # the scan's unroll factor is accepted and changes nothing
    assert tasmc.SimpleAsmcEnvConfig(substep_unroll=4).substep_unroll == 4

"""The port's vehicle physics against ``usv_tpu.physics``, on the CPU.

Inputs come from a numpy seed and go through the JAX function and its
counterpart. JAX runs op by op (``vmap`` without ``jit``), so that neither
side contracts ``a + b * c`` into an FMA.

* ``VehicleParams``: every field and derived mass equal.
* One call of each function from identical inputs (B=64): rtol=2e-6 with
  atol=1e-5 (a few float32 ulps: XLA's and PyTorch's cos, sin and hypot may
  differ in the last bit). The speed switch at |u| = 1.2 is exercised on both
  sides and straddled by no input.
* One dynamics substep from identical states: atol=1e-5, rtol=2e-6.
* A 500-substep trajectory under random thrusts, each side evolving on its
  own: atol=2e-4, rtol=2e-4, the bound the JAX suite holds its own
  trajectory to against the float64 oracle.
* The same trajectory against the float64 native oracle, as
  ``tests/test_native_parity.py`` does it (skipped where the oracle cannot
  build).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu.physics) needs flax")

from usv_tpu.physics import dynamics as jdyn
from usv_tpu.physics.params import VehicleParams as JParams
from usv_tpu_torch.convert import dynamics_state_from_numpy
from usv_tpu_torch.physics import dynamics as tdyn
from usv_tpu_torch.physics.params import VehicleParams as TParams

CPU = torch.device("cpu")
JVP, TVP = JParams(), TParams()
B = 64
TIGHT = dict(atol=1e-5, rtol=2e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _vel(rng, n=B):
    """Body velocities on both sides of the |u| = 1.2 switch, none within
    1e-3 of it."""
    vel = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    near = np.abs(np.abs(vel[:, 0]) - 1.2) < 1e-3
    vel[near, 0] = 0.5
    return vel


def _random_state(rng, n=B):
    return dict(
        pose=np.concatenate([rng.uniform(-20, 20, (n, 2)), rng.uniform(-7, 7, (n, 1))], 1)
        .astype(np.float32),
        vel=_vel(rng, n),
        accel_last=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        eta_dot_last=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
    )


def test_vehicle_params_equal():
    for f in dataclasses.fields(TParams):
        assert getattr(TVP, f.name) == getattr(JVP, f.name), f.name
    for name in ("m11", "m22", "m23", "m32", "m33"):
        assert getattr(TVP, name) == getattr(JVP, name), name
    assert tdyn._REF_PI == jdyn._REF_PI and tdyn._YV_FORM_FACTOR == jdyn._YV_FORM_FACTOR


def test_hydrodynamic_coefficients_and_model_terms_match_jax():
    vel = _vel(np.random.default_rng(0))
    u, v, r = vel.T
    assert (np.abs(u) > 1.2).any() and (np.abs(u) < 1.2).any()
    want = jax.vmap(jdyn.hydrodynamic_coefficients)(jnp.asarray(u), jnp.asarray(v))
    got = tdyn.hydrodynamic_coefficients(_t(u), _t(v))
    for g, w, name in zip(got, want, ("Xu", "Xuu", "Yv", "Yr", "Nv", "Nr")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TIGHT)
    want = jax.vmap(lambda a, b, c: jdyn.surge_yaw_model_terms(JVP, a, b, c)[:2])(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(r))
    f_u, f_psi, g_u, g_psi = tdyn.surge_yaw_model_terms(TVP, _t(u), _t(v), _t(r))
    np.testing.assert_allclose(f_u.numpy(), np.asarray(want[0]), **TIGHT)
    np.testing.assert_allclose(f_psi.numpy(), np.asarray(want[1]), **TIGHT)
    assert (g_u, g_psi) == jdyn.surge_yaw_model_terms(JVP, 0.0, 0.0, 0.0)[2:]


def test_allocation_acceleration_and_perturbation_match_jax():
    rng = np.random.default_rng(1)
    vel = _vel(rng)
    tp, ts = rng.uniform(-30, 36, (2, B)).astype(np.float32)
    tau = rng.uniform(-40, 40, (3, B)).astype(np.float32)
    want = jax.vmap(lambda a, b: jdyn.thruster_allocation(JVP, a, b))(jnp.asarray(tp), jnp.asarray(ts))
    got = tdyn.thruster_allocation(TVP, _t(tp), _t(ts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TIGHT)

    want = jax.vmap(lambda v_, a, b, c: jdyn.fossen_acceleration(JVP, v_, a, b, c))(
        jnp.asarray(vel), *map(jnp.asarray, tau))
    got = tdyn.fossen_acceleration(TVP, _t(vel), *map(_t, tau))
    # accelerations reach ~1e3 where |v| ~ 2.5 (the quadratic sway damping)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=5e-6)

    psi = rng.uniform(-7, 7, B).astype(np.float32)
    step = rng.integers(0, 400, B).astype(np.float32)
    want = jax.vmap(lambda p, s: jdyn.perturbation_force(p, s, 0.01, 10.0, 5.0))(
        jnp.asarray(psi), jnp.asarray(step))
    got = tdyn.perturbation_force(_t(psi), _t(step), 0.01, 10.0, 5.0)
    for g, w in zip(got, want):
        # cos of arguments up to ~250 rad: an ulp of the argument is 1.5e-5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=0)


@pytest.mark.parametrize("perturbed", [False, True])
def test_dynamics_substep_matches_jax(perturbed):
    rng = np.random.default_rng(2)
    s = _random_state(rng)
    # moderate speeds: the substep's sums stay O(10), where atol=1e-5 is ~10 ulps
    s["vel"] = (s["vel"] * 0.5).astype(np.float32)
    tp, ts = rng.uniform(-30, 36, (2, B)).astype(np.float32)
    p = rng.uniform(-5, 5, (3, B)).astype(np.float32) if perturbed else np.zeros((3, B), np.float32)
    jstate = jdyn.DynamicsState(**{k: jnp.asarray(v) for k, v in s.items()})
    want = jax.vmap(lambda st, a, b, x, y, z: jdyn.dynamics_step(JVP, st, a, b, 0.01, x, y, z))(
        jstate, jnp.asarray(tp), jnp.asarray(ts), *map(jnp.asarray, p))
    tstate = dynamics_state_from_numpy(s, CPU)
    if perturbed:
        got = tdyn.dynamics_step(TVP, tstate, _t(tp), _t(ts), 0.01, *map(_t, p))
    else:
        got = tdyn.dynamics_step(TVP, tstate, _t(tp), _t(ts), 0.01)
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)),
                                   err_msg=f.name, **TIGHT)


def _thrusts(n_steps, n):
    return np.random.default_rng(0).uniform(-20, 30, (n_steps, 2, n)).astype(np.float32)


def test_dynamics_trajectory_500_steps_matches_jax():
    n, n_steps = 8, 500
    thrust = _thrusts(n_steps, n)
    jstate = jax.vmap(lambda _: jdyn.init_dynamics(1.0, -2.0, 0.3))(jnp.arange(n))
    jstep = jax.jit(jax.vmap(lambda s, a, b: jdyn.dynamics_step(JVP, s, a, b, 0.01)))
    tstate = tdyn.init_dynamics(1.0, -2.0, 0.3, batch_shape=(n,))
    for t in range(n_steps):
        jstate = jstep(jstate, jnp.asarray(thrust[t, 0]), jnp.asarray(thrust[t, 1]))
        tstate = tdyn.dynamics_step(TVP, tstate, _t(thrust[t, 0]), _t(thrust[t, 1]), 0.01)
    assert np.abs(np.asarray(jstate.pose[:, :2])).max() > 1.0  # the boats moved
    for name in ("pose", "vel"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
                                   atol=2e-4, rtol=2e-4, err_msg=name)


def test_dynamics_trajectory_matches_native_oracle():
    native = pytest.importorskip("usv_tpu.native")
    model = native.DynamicModel(1.0, -2.0, 0.3)
    state = tdyn.init_dynamics(1.0, -2.0, 0.3, batch_shape=(1,))
    rng = np.random.default_rng(0)
    for _ in range(500):
        tp, ts = float(rng.uniform(-20, 30)), float(rng.uniform(-20, 30))
        model.update(tp, ts)
        state = tdyn.dynamics_step(TVP, state, torch.full((1,), tp), torch.full((1,), ts), 0.01)
    np.testing.assert_allclose(state.pose[0].numpy(), model.pose, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.vel[0].numpy(), model.vel, rtol=2e-4, atol=2e-4)

"""The port's controllers against ``usv_tpu.control``, on the CPU.

Inputs come from a numpy seed and go through the JAX function and its
counterpart.

* One control update from identical states (B=64), JAX op by op (``vmap``
  without ``jit``: no FMA contraction): state, thrusts and every debug value
  at atol=1e-5 with rtol=1e-5 (thrusts reach ~1e2). Both controllers switch
  on signs (``sign(|sigma| - mu)``, ``ka > kmin``, ``sign(sigma)``); the
  inputs are drawn so that no env sits within 1e-4 of a switching surface,
  which the test asserts: a case on a surface may flip with the last bit of a
  cos or a hypot, and is then 2 k apart in ``ka_dot``, not 1e-5.
* ``asmc_control`` in both heading modes, with absolute-heading setpoints
  that cross the +-pi seam against the previous setpoint.
* The whole ``*_compute`` loops (10, 20 and 5 substeps) from identical
  states, with ``jax.disable_jit()`` so that the scan runs op by op: last
  substep, final state and the stacked history at atol=1e-4, rtol=1e-4. Ten
  substeps compound the last-bit differences of cos/sin/hypot through the
  1/dt = 100 gains of the reference filter.
* ``do_perturb`` at the controller level, where every path of this slice
  leaves it off.
* ``run_controller_and_model`` and ``pid_compute`` against their JAX forms.
* The three controllers in closed loop against the float64 native oracle,
  with the bounds of ``tests/test_native_parity.py`` (skipped where the
  oracle cannot build).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu.control) needs flax")

from usv_tpu.control import aitsmc as jait
from usv_tpu.control import asmc as jasmc
from usv_tpu.control import pid as jpid
from usv_tpu.control.runner import run_controller_and_model as jrun
from usv_tpu.physics import dynamics as jdyn
from usv_tpu.physics.params import VehicleParams as JParams
from usv_tpu_torch import convert
from usv_tpu_torch.control import aitsmc as tait
from usv_tpu_torch.control import asmc as tasmc
from usv_tpu_torch.control import pid as tpid
from usv_tpu_torch.control.runner import run_controller_and_model as trun
from usv_tpu_torch.physics import dynamics as tdyn
from usv_tpu_torch.physics.params import VehicleParams as TParams

CPU = torch.device("cpu")
JVP, TVP = JParams(), TParams()
B = 64
UPDATE = dict(atol=1e-5, rtol=1e-5)
LOOP = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _to_numpy(state):
    """A (vmapped) JAX state as a (nested) dict of numpy arrays."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out[f.name] = _to_numpy(v) if dataclasses.is_dataclass(v) else np.array(v)
    return out


def _assert_tree_close(got, want, rows=None, **tol):
    """A port state (or dict, or tuple) against a JAX one, leaf by leaf; with
    ``rows`` (a bool mask over the batch) only those envs."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _assert_tree_close(getattr(got, f.name), getattr(want, f.name), rows=rows, **tol)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_close(got[k], want[k], rows=rows, **tol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w, rows=rows, **tol)
    else:
        want = np.asarray(want)
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        want = np.broadcast_to(want, got.shape)
        if rows is not None:
            got, want = got[rows], want[rows]
        if want.dtype.kind in "bi":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **tol)


def _dyn(rng, n=B):
    """Poses with headings beyond +-pi and moderate speeds, away from the
    |u| = 1.2 switch."""
    vel = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    return dict(
        pose=np.concatenate([rng.uniform(-20, 20, (n, 2)), rng.uniform(-7, 7, (n, 1))], 1)
        .astype(np.float32),
        vel=vel,
        accel_last=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        eta_dot_last=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
    )


def _asmc_state(rng, n=B):
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    return dict(
        psi_d_last=f(-3.1, 3.1), o=f(-1, 1), o_dot=f(-1, 1), o_dot_dot_last=f(-1, 1),
        e_u_last=f(-1, 1), e_u_int=f(-1, 1),
        # on both sides of the floors kmin_u = 0.05 and kmin_psi = 0.2
        ka_u=np.where(rng.random(n) < 0.5, f(0.0, 0.04), f(0.06, 0.5)).astype(np.float32),
        ka_psi=np.where(rng.random(n) < 0.5, f(0.0, 0.19), f(0.21, 0.8)).astype(np.float32),
        ka_dot_u_last=f(-0.1, 0.1), ka_dot_psi_last=f(-0.2, 0.2),
    )


def _jax_tree(cls, leaves):
    return cls(**{k: jnp.asarray(v) for k, v in leaves.items()})


def _off_surfaces(debug, mus):
    """The envs at least 1e-4 from every switching surface of the update
    (|sigma| = mu and sigma = 0), which must be nearly all of them."""
    rows = np.ones(B, bool)
    for name, mu in mus.items():
        sigma = np.abs(np.asarray(debug[name]))
        rows &= (np.abs(sigma - mu) > 1e-4) & (sigma > 1e-4)
    assert rows.sum() >= B - 2
    return rows


@pytest.mark.parametrize("absolute_heading", [False, True])
def test_asmc_control_update_matches_jax(absolute_heading):
    rng = np.random.default_rng(10 + absolute_heading)
    dyn, ctrl = _dyn(rng), _asmc_state(rng)
    u_d = rng.uniform(-1, 1.5, B).astype(np.float32)
    if absolute_heading:
        # setpoints hugging the seam on the side opposite to the previous one
        heading = (-np.sign(ctrl["psi_d_last"]) * rng.uniform(3.0, np.pi, B)).astype(np.float32)
        heading[::2] = rng.uniform(-np.pi, np.pi, B // 2)
        assert (np.abs(heading - ctrl["psi_d_last"]) > np.pi).sum() > 10
    else:
        heading = rng.uniform(-1, 1, B).astype(np.float32)
    gj, gt = jasmc.AsmcGains(), tasmc.AsmcGains()
    want = jax.vmap(lambda s, a, h, p, v: jasmc.asmc_control(
        gj, JVP, s, a, h, p, v, 0.01, absolute_heading=absolute_heading))(
            _jax_tree(jasmc.AsmcState, ctrl), jnp.asarray(u_d), jnp.asarray(heading),
            jnp.asarray(dyn["pose"]), jnp.asarray(dyn["vel"]))
    got = tasmc.asmc_control(gt, TVP, convert.asmc_state_from_numpy(ctrl, CPU), _t(u_d),
                             _t(heading), _t(dyn["pose"]), _t(dyn["vel"]), 0.01,
                             absolute_heading=absolute_heading)
    rows = _off_surfaces(want[3], {"sigma_u": gj.mu_u, "sigma_psi": gj.mu_psi})
    _assert_tree_close(got, want, rows=rows, **UPDATE)


def test_asmc_control_takes_python_setpoints():
    """Scalar setpoints, as the oracle-style callers pass them."""
    state = tasmc.init_asmc((3,))
    dyn = tdyn.init_dynamics(batch_shape=(3,))
    for absolute in (False, True):
        new, tp, ts, dbg = tasmc.asmc_control(tasmc.AsmcGains(), TVP, state, 1.0, 0.1,
                                              dyn.pose, dyn.vel, absolute_heading=absolute)
        assert tp.shape == (3,) and new.psi_d_last.shape == (3,)


def _ait_state(rng, n=B):
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    return dict(
        e_u_int=f(-1, 1), e_r_int=f(-1, 1), e_u_last=f(-1, 1), e_r_last=f(-1, 1),
        ka_u=np.where(rng.random(n) < 0.5, f(0.0, 0.04), f(0.06, 0.5)).astype(np.float32),
        ka_r=np.where(rng.random(n) < 0.5, f(0.0, 0.04), f(0.06, 0.5)).astype(np.float32),
        ka_dot_u_last=f(-0.1, 0.1), ka_dot_r_last=f(-0.2, 0.2),
    )


def test_aitsmc_control_update_matches_jax():
    rng = np.random.default_rng(20)
    dyn, ctrl = _dyn(rng), _ait_state(rng)
    sp = {k: rng.uniform(-1, 1, B).astype(np.float32) for k in ("u", "r", "dot_u", "dot_r")}
    gj, gt = jait.AitsmcGains(), tait.AitsmcGains()
    want = jax.vmap(lambda s, p, v: jait.aitsmc_control(gj, JVP, s, p, v, 0.01))(
        _jax_tree(jait.AitsmcState, ctrl), _jax_tree(jait.AitsmcSetpoint, sp),
        jnp.asarray(dyn["vel"]))
    got = tait.aitsmc_control(gt, TVP, convert.aitsmc_state_from_numpy(ctrl, CPU),
                              tait.AitsmcSetpoint(**{k: _t(v) for k, v in sp.items()}),
                              _t(dyn["vel"]), 0.01)
    rows = _off_surfaces(want[3], {"sigma_u": gj.mu_u, "sigma_r": gj.mu_r})
    assert (np.asarray(want[1]) == gj.t_max).any() or (np.asarray(want[1]) == gj.t_min).any()
    _assert_tree_close(got, want, rows=rows, **UPDATE)
    # the e_u/e_r properties are the last errors
    assert got[0].e_u is got[0].e_u_last and got[0].e_r is got[0].e_r_last


@pytest.mark.parametrize("freeze", [True, False])
def test_pid_control_update_matches_jax(freeze):
    rng = np.random.default_rng(30)
    dyn = _dyn(rng)
    ctrl = dict(e_u_last=rng.uniform(-0.1, 0.1, B).astype(np.float32),
                e_u_int=rng.uniform(-1, 1, B).astype(np.float32))
    u_d, heading = rng.uniform(-1, 1.5, (2, B)).astype(np.float32)
    gj = jpid.PidGains(freeze_e_u_last=freeze)
    gt = tpid.PidGains(freeze_e_u_last=freeze)
    want = jax.vmap(lambda s, a, h, p, v: jpid.pid_control(gj, JVP, s, a, h, p, v, 0.01))(
        _jax_tree(jpid.PidState, ctrl), jnp.asarray(u_d), jnp.asarray(heading),
        jnp.asarray(dyn["pose"]), jnp.asarray(dyn["vel"]))
    got = tpid.pid_control(gt, TVP, convert.state_from_numpy(tpid.PidState, ctrl, CPU), _t(u_d),
                           _t(heading), _t(dyn["pose"]), _t(dyn["vel"]), 0.01)
    _assert_tree_close(got[0], want[0], **UPDATE)
    # the thrusts carry the last bit of the double atan2 wrap (~2e-7 rad)
    # through kp_psi / (g_psi B) = 22.6 * 6.89 / 0.41 = 380, and that of e_u
    # through kd_u / (dt g_u) = 320: a few 1e-4 on thrusts of up to 30
    _assert_tree_close(got[1:], want[1:], atol=5e-4, rtol=1e-5)
    assert (np.abs(np.asarray(want[1])) == gj.thrust_limit).any()  # the clip is live


def _warm_pose(rng, n):
    return [jnp.asarray(a, jnp.float32) for a in
            (rng.uniform(-20, 20, n), rng.uniform(-20, 20, n), rng.uniform(-7, 7, n))]


def _loops(rng, n, absolute_heading):
    """Loop states a boat really reaches (random ones diverge: the sway
    damping is stiff): from rest at a random pose, 30 jitted JAX substeps
    under a random setpoint."""
    jloop = jax.vmap(lambda x, y, p: jasmc.init_asmc_loop(x, y, p))(*_warm_pose(rng, n))
    warm = np.stack([rng.uniform(0.3, 1.5, n), rng.uniform(-1, 1, n)], 1).astype(np.float32)
    jloop = jax.jit(jax.vmap(lambda l, a: jasmc.asmc_compute(
        jasmc.AsmcGains(), JVP, l, a, n_substeps=30, absolute_heading=absolute_heading)[0]))(
            jloop, jnp.asarray(warm))
    leaves = _to_numpy(jloop)
    tloop = tasmc.AsmcLoopState(ctrl=convert.asmc_state_from_numpy(leaves["ctrl"], CPU),
                                dyn=convert.dynamics_state_from_numpy(leaves["dyn"], CPU),
                                perturb_step=torch.from_numpy(leaves["perturb_step"]))
    return jloop, tloop


@pytest.mark.parametrize("absolute_heading,do_perturb,n_substeps", [
    (False, False, 10), (True, False, 10), (False, True, 10), (False, False, 20)])
def test_asmc_compute_matches_jax(absolute_heading, do_perturb, n_substeps):
    n = 16
    rng = np.random.default_rng(40 + n_substeps + absolute_heading + 2 * do_perturb)
    jloop, tloop = _loops(rng, n, absolute_heading)
    action = np.stack([rng.uniform(0, 1.5, n), rng.uniform(-1, 1, n)], 1).astype(np.float32)
    with jax.disable_jit():
        jnew, jhist = jax.vmap(lambda l, a: jasmc.asmc_compute(
            jasmc.AsmcGains(), JVP, l, a, do_perturb=do_perturb, n_substeps=n_substeps,
            absolute_heading=absolute_heading))(jloop, jnp.asarray(action))
    tnew, last, hist = tasmc.asmc_compute(
        tasmc.AsmcGains(), TVP, tloop, _t(action), do_perturb=do_perturb,
        n_substeps=n_substeps, absolute_heading=absolute_heading, unroll=4, keep_history=True)
    _assert_tree_close(tnew, jnew, **LOOP)
    assert int(tnew.perturb_step[0]) == int(tloop.perturb_step[0]) + n_substeps
    assert sorted(hist) == sorted(jhist) and hist["pose"].shape == (n, n_substeps, 3)
    _assert_tree_close(hist, jhist, **LOOP)
    for k, v in last.items():
        assert torch.equal(v, hist[k][:, -1]), k
    # without the history the loop returns the same state and last substep
    tnew2, last2, none = tasmc.asmc_compute(
        tasmc.AsmcGains(), TVP, tloop, _t(action), do_perturb=do_perturb,
        n_substeps=n_substeps, absolute_heading=absolute_heading)
    assert none is None and torch.equal(tnew2.dyn.pose, tnew.dyn.pose)
    assert torch.equal(last2["tport"], last["tport"])
    if do_perturb:
        quiet, _, _ = tasmc.asmc_compute(tasmc.AsmcGains(), TVP, tloop, _t(action),
                                         n_substeps=n_substeps)
        assert not torch.allclose(quiet.dyn.vel, tnew.dyn.vel, atol=1e-3)


@pytest.mark.parametrize("perturbed", [False, True])
def test_aitsmc_compute_matches_jax(perturbed):
    n = 16
    rng = np.random.default_rng(50 + perturbed)
    sp = {k: rng.uniform(-0.5, 1.0, n).astype(np.float32) for k in ("u", "r")}
    sp.update(dot_u=np.zeros(n, np.float32), dot_r=np.zeros(n, np.float32))
    perturb = rng.uniform(-3, 3, (n, 3)).astype(np.float32) if perturbed else None
    # a state the boat really reaches: 30 jitted JAX substeps from rest
    jloop = jax.vmap(lambda x, y, p: jait.AitsmcLoopState(
        ctrl=jait.init_aitsmc(), dyn=jdyn.init_dynamics(x, y, p)))(*_warm_pose(rng, n))
    jloop = jax.jit(jax.vmap(lambda l, s: jait.aitsmc_compute(
        jait.AitsmcGains(), JVP, l, s, n_substeps=30)[0]))(
            jloop, _jax_tree(jait.AitsmcSetpoint, {k: v[::-1].copy() for k, v in sp.items()}))
    leaves = _to_numpy(jloop)
    tloop = tait.AitsmcLoopState(ctrl=convert.aitsmc_state_from_numpy(leaves["ctrl"], CPU),
                                 dyn=convert.dynamics_state_from_numpy(leaves["dyn"], CPU))
    with jax.disable_jit():
        if perturbed:
            jnew, jhist = jax.vmap(lambda l, s, p: jait.aitsmc_compute(
                jait.AitsmcGains(), JVP, l, s, p))(
                    jloop, _jax_tree(jait.AitsmcSetpoint, sp), jnp.asarray(perturb))
        else:
            jnew, jhist = jax.vmap(lambda l, s: jait.aitsmc_compute(
                jait.AitsmcGains(), JVP, l, s))(jloop, _jax_tree(jait.AitsmcSetpoint, sp))
    tsp = tait.AitsmcSetpoint(**{k: _t(v) for k, v in sp.items()})
    tnew, last, hist = tait.aitsmc_compute(
        tait.AitsmcGains(), TVP, tloop, tsp, None if perturb is None else _t(perturb),
        keep_history=True)
    _assert_tree_close(tnew, jnew, **LOOP)
    _assert_tree_close(hist, jhist, **LOOP)
    assert hist["tport"].shape == (n, 5) and torch.equal(last["tport"], hist["tport"][:, -1])


def test_pid_compute_and_runner_match_jax():
    n, n_substeps = 16, 10
    rng = np.random.default_rng(60)
    dyn = {k: v * np.float32(k == "pose") for k, v in _dyn(rng, n).items()}  # at rest
    ctrl = dict(e_u_last=np.zeros(n, np.float32), e_u_int=rng.uniform(-1, 1, n).astype(np.float32))
    action = np.stack([rng.uniform(0, 1.5, n), rng.uniform(-1, 1, n)], 1).astype(np.float32)
    jd, jc = _jax_tree(jdyn.DynamicsState, dyn), _jax_tree(jpid.PidState, ctrl)
    td = convert.dynamics_state_from_numpy(dyn, CPU)
    tc = convert.state_from_numpy(tpid.PidState, ctrl, CPU)
    step = jnp.zeros(n, jnp.int32)
    with jax.disable_jit():
        jnew, jhist = jax.vmap(lambda c, d, s, a: jpid.pid_compute(
            jpid.PidGains(), JVP, jpid.PidLoopState(ctrl=c, dyn=d, perturb_step=s), a))(
                jc, jd, step, jnp.asarray(action))
        jout = jax.vmap(lambda c, d, a: jrun(
            lambda cs, ds: jpid.pid_control(jpid.PidGains(), JVP, cs, a[0], a[1], ds.pose, ds.vel),
            JVP, c, d, n_substeps))(jc, jd, jnp.asarray(action))
    tloop = tpid.PidLoopState(ctrl=tc, dyn=td, perturb_step=torch.zeros(n, dtype=torch.int32))
    tnew, last, hist = tpid.pid_compute(tpid.PidGains(), TVP, tloop, _t(action), keep_history=True)
    # the PD heading loop's gains (22.6, 10) carry last-bit differences into
    # thrusts of up to 30: a looser bound than the sliding-mode loops'
    tol = dict(atol=5e-4, rtol=1e-4)
    _assert_tree_close(tnew, jnew, **tol)
    _assert_tree_close(hist, jhist, **tol)
    a = _t(action)
    tout = trun(lambda cs, ds: tpid.pid_control(tpid.PidGains(), TVP, cs, a[:, 0], a[:, 1],
                                                ds.pose, ds.vel), TVP, tc, td, n_substeps)
    assert tout[2]["pose"].shape == (n, n_substeps, 3)
    for got, want in zip(tout, jout):
        _assert_tree_close(got, want, **tol)
    assert torch.equal(tout[1].pose, tnew.dyn.pose)  # the runner is the same loop


# --- the float64 native oracle, as tests/test_native_parity.py holds JAX to it


@pytest.fixture(scope="module")
def native():
    return pytest.importorskip("usv_tpu.native")


def _one(x):
    return torch.full((1,), float(x))


@pytest.mark.parametrize("mode", ["offset", "absolute", "perturbed"])
def test_asmc_closed_loop_matches_native_oracle(native, mode):
    model, asmc = native.DynamicModel(), native.ASMC()
    loop = tasmc.init_asmc_loop(batch_shape=(1,))
    rng = np.random.default_rng(5)
    n_steps = 50 if mode == "perturbed" else 100
    for i in range(n_steps):
        if mode == "absolute":
            u_d = 1.2
            heading = float((np.pi - 0.05) * (-1) ** i + rng.uniform(-0.02, 0.02))
        else:
            u_d, heading = (1.0, 0.0) if mode == "perturbed" else (1.5, 0.2)
        asmc.compute(model, u_d, heading, n=10, absolute_heading=mode == "absolute",
                     do_perturb=mode == "perturbed")
        loop, _, _ = tasmc.asmc_compute(
            tasmc.AsmcGains(), TVP, loop, torch.tensor([[u_d, heading]]),
            absolute_heading=mode == "absolute", do_perturb=mode == "perturbed")
    np.testing.assert_allclose(loop.dyn.pose[0].numpy(), model.pose, rtol=5e-3, atol=5e-3)
    if mode != "perturbed":
        np.testing.assert_allclose(loop.dyn.vel[0].numpy(), model.vel, rtol=5e-3, atol=5e-3)
    assert int(loop.perturb_step) == 10 * n_steps


def test_pid_single_updates_match_native_oracle(native):
    model, pid = native.DynamicModel(), native.PID()
    state = tpid.init_pid((1,))
    dyn = tdyn.init_dynamics(batch_shape=(1,))
    for _ in range(200):
        tp, ts = pid.control(model, 1.0, 0.1)
        state, ttp, tts, _ = tpid.pid_control(tpid.PidGains(), TVP, state, 1.0, 0.1,
                                              dyn.pose, dyn.vel)
        np.testing.assert_allclose(float(ttp), tp, rtol=1e-3, atol=1e-3)
        model.update(tp, ts)
        dyn = tdyn.dynamics_step(TVP, dyn, ttp, tts, 0.01)


def test_aitsmc_closed_loop_matches_native_oracle(native):
    model, ai = native.DynamicModel(), native.AITSMC()
    loop = tait.AitsmcLoopState(ctrl=tait.init_aitsmc((1,)),
                                dyn=tdyn.init_dynamics(batch_shape=(1,)))
    sp = tait.AitsmcSetpoint(u=_one(0.6), r=_one(0.2), dot_u=_one(0.0), dot_r=_one(0.0))
    for _ in range(100):
        for _ in range(5):
            tp, ts = ai.update(model, 0.6, 0.2)
            model.update(tp, ts)
        loop, _, _ = tait.aitsmc_compute(tait.AitsmcGains(), TVP, loop, sp, n_substeps=5)
    np.testing.assert_allclose(loop.dyn.pose[0].numpy(), model.pose, rtol=5e-3, atol=5e-3)
    dbg = ai.get_debug_data()
    np.testing.assert_allclose(float(loop.ctrl.ka_u), dbg["Ka_u"], rtol=5e-3, atol=1e-4)

"""The port's ``usv-curved-aitsmc`` against ``usv_tpu.envs.curved``, on the CPU.

* ``build_from_draws`` fed the arrays the JAX reset draws from
  ``jax.random.split(key, 9)``: floats at atol=1e-6 with rtol=1e-6, the mask
  and the counters exactly. Obstacle centres at atol=5e-6: a centre is a path
  point of up to ~24 m (one float32 ulp: 1.9e-6) plus a displacement of up to
  ~16 m through a cos and a sin, and XLA's and PyTorch's cos and sin differ
  by an ulp on some arguments. The reset obs at atol=1e-6.
* One step from converted JAX states (B=16, warmed by a few jitted JAX
  steps), JAX op by op (``jax.disable_jit()``): obs and reward at atol=1e-5,
  flags exactly, every info key and state leaf at atol=1e-5 with rtol=1e-5;
  with the true-min ray-cast as well.
* A 15-step run, each side on its own against the jitted JAX step: obs and
  reward within 2e-4, flags equal (loose for the reasons
  ``tests/test_torch_hydro_envs.py`` gives).
* Arrival, collision, off-track and time-limit termination on constructed
  states; the uniform sampler's marginals, statistically.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu.envs) needs flax")

from usv_tpu.envs import curved as jcv
from usv_tpu_torch.convert import curved_state_from_numpy
from usv_tpu_torch.envs import curved as tcv

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)


def to_numpy(state):
    """A vmapped JAX state as a (nested) dict of numpy arrays, keys dropped."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name != "key":
            out[f.name] = to_numpy(v) if dataclasses.is_dataclass(v) else np.array(v)
    return out


def from_numpy(jstate, leaves):
    """``leaves`` (a ``to_numpy`` dict, edited) back into a JAX state with
    ``jstate``'s keys."""
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


def assert_timestep_close(tts, jts, atol, info_tol=None):
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs), atol=atol, rtol=0)
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), atol=atol, rtol=1e-6)
    np.testing.assert_array_equal(tts.terminated.numpy(), np.asarray(jts.terminated))
    np.testing.assert_array_equal(tts.truncated.numpy(), np.asarray(jts.truncated))
    if info_tol is not None:
        assert sorted(tts.info) == sorted(jts.info)
        for k, v in jts.info.items():
            v = np.asarray(v)
            if v.dtype == np.bool_:
                np.testing.assert_array_equal(tts.info[k].numpy(), v, err_msg=k)
            else:
                np.testing.assert_allclose(tts.info[k].numpy(), v, err_msg=k, **info_tol)


def jax_reset_draws(cfg, keys):
    """The arrays ``usv_tpu.envs.curved.reset`` draws from its nine keys, in
    the form ``build_from_draws`` takes them."""
    W, K = cfg.num_waypoints, cfg.obstacle_cap

    def draws(key):
        ks = jax.random.split(key, 9)
        return dict(
            angles=jax.random.normal(ks[0], (W,)),
            lengths=jax.random.normal(ks[1], (W,)),
            psi0=jax.random.uniform(ks[2], minval=-np.pi / 4, maxval=np.pi / 4),
            base_u=jax.random.uniform(ks[3], (K,)),
            displacement=jax.random.normal(ks[4], (K,)),
            off_angle=jax.random.uniform(ks[5], (K,), minval=np.pi, maxval=2 * np.pi),
            obs_r=jax.random.normal(ks[6], (K,)),
            n_obs=jax.random.randint(ks[7], (), 4, K),
        )

    return {k: torch.from_numpy(np.array(v)) for k, v in jax.vmap(draws)(keys).items()}


def test_reset_transform_matches_jax():
    jcfg, tcfg = jcv.CurvedEnvConfig(), tcv.CurvedEnvConfig()
    keys = jax.random.split(jax.random.key(41), 128)
    want = jax.vmap(lambda k: jcv.reset(jcfg, k))(keys)
    got = tcv.build_from_draws(tcfg, **jax_reset_draws(jcfg, keys))
    assert_state_close(got, to_numpy(want), atol=1e-6, rtol=1e-6, leaf_atol={"obs_xy": 5e-6})
    jobs = jax.vmap(lambda s: jcv.reset_obs(jcfg, s))(want)
    np.testing.assert_allclose(tcv.reset_obs(tcfg, got).numpy(), np.asarray(jobs), atol=1e-6, rtol=0)
    # every path starts at the origin and runs forward; no ray is cast at reset
    assert (got.waypoints[:, 0] == 0).all()
    assert (got.waypoints[:, 1:, 0] > got.waypoints[:, :-1, 0]).all()
    assert (got.sensor_dist == tcfg.sensor_max_range).all()
    counts = got.obs_mask.sum(-1)
    assert counts.max() <= tcfg.obstacle_cap - 1 and counts.float().mean() > 3


def test_reset_from_uniform_layout_and_shapes():
    cfg = tcv.CurvedEnvConfig()
    assert tcv.n_uniform(cfg) == 2 + 2 * 16 + 2 * (8 + 16) == 82
    with pytest.raises(ValueError, match="uniform block"):
        tcv.reset_from_uniform(cfg, torch.zeros(4, 81))
    B = 6
    u = torch.rand((B, 82), generator=torch.Generator().manual_seed(2))
    state = tcv.reset_from_uniform(cfg, u)
    # the block's layout: psi0, n_obs, base_u, off_angle, then the Box-Muller runs
    torch.testing.assert_close(state.dyn.pose[:, 2], u[:, 0] * (math.pi / 2) - math.pi / 4)
    n_obs = 4 + torch.floor(u[:, 1] * 12).to(torch.int32)
    assert (state.obs_mask.sum(-1) <= n_obs).all()
    assert not state.obs_mask[torch.arange(16) >= n_obs[:, None]].any()
    n0, n1 = tcv.box_muller(u[:, 34:58], u[:, 58:82])
    same = tcv.build_from_draws(cfg, n0[:, :8], n1[:, :8], state.dyn.pose[:, 2], u[:, 2:18],
                                n0[:, 8:], u[:, 18:34] * math.pi + math.pi, n1[:, 8:], n_obs)
    assert torch.equal(same.obs_xy, state.obs_xy) and torch.equal(same.path.d, state.path.d)
    drawn = tcv.reset(cfg, torch.Generator().manual_seed(0), 5, CPU)
    assert drawn.path.x.shape == (5, 8) and drawn.waypoints.shape == (5, 8, 2)
    assert tcv.reset_obs(cfg, drawn).shape == (5, cfg.obs_dim) == (5, 41)
    # other sizes
    small = tcv.CurvedEnvConfig(num_waypoints=5, obstacle_cap=8, sensor_count=8)
    s = tcv.reset(small, torch.Generator().manual_seed(0), 3, CPU)
    assert s.path.x.shape == (3, 5) and s.obs_mask.shape == (3, 8)
    assert tcv.step(small, s, torch.zeros(3, 2))[1].obs.shape == (3, 17)


def test_uniform_sampler_marginals():
    """The block's transform gives the JAX reset's distributions: standard
    normals behind the waypoint and obstacle draws, U[-pi/4, pi/4) headings,
    and ``n_obs`` uniform over 4..K-1. 20,000 envs; bounds are ~5 sigma."""
    cfg = tcv.CurvedEnvConfig()
    B, K, W = 20_000, cfg.obstacle_cap, cfg.num_waypoints
    u = torch.rand((B, tcv.n_uniform(cfg)), generator=torch.Generator().manual_seed(7))
    n0, n1 = tcv.box_muller(u[:, 34:58], u[:, 58:82])
    for z in (n0, n1):
        assert abs(float(z.mean())) < 5 / math.sqrt(z.numel())
        assert abs(float(z.var()) - 1.0) < 5 * math.sqrt(2 / z.numel())
        assert abs(float((z ** 4).mean()) - 3.0) < 0.1
    assert abs(float((n0 * n1).mean())) < 5 / math.sqrt(n0.numel())
    state = tcv.reset_from_uniform(cfg, u)
    psi = state.dyn.pose[:, 2]
    assert psi.min() >= -math.pi / 4 and psi.max() < math.pi / 4
    assert abs(float(psi.mean())) < 5 * (math.pi / 2) / math.sqrt(12 * B)
    # the step lengths are N(3, 0.1): the waypoint spacing shows them
    seg = torch.linalg.vector_norm(state.waypoints[:, 1:] - state.waypoints[:, :-1], dim=-1)
    assert abs(float(seg.mean()) - cfg.length_mean) < 5 * cfg.length_std / math.sqrt(seg.numel())
    assert abs(float(seg.std()) - cfg.length_std) < 0.005
    # n_obs: the highest valid slot + 1 is at most n_obs; count the pmf of the
    # floored draw itself
    n_obs = 4 + torch.floor(u[:, 1] * (K - 4)).to(torch.int64)
    pmf = torch.bincount(n_obs, minlength=K).float() / B
    assert pmf[:4].sum() == 0 and pmf[K:].sum() == 0
    p = 1 / (K - 4)
    assert (pmf[4:K] - p).abs().max() < 5 * math.sqrt(p * (1 - p) / B)
    assert W == 8


def _actions(rng, B):
    return rng.uniform(-1, 1, (B, 2)).astype(np.float32)


def _warm_jax_states(jcfg, B, n_steps, seed):
    rng = np.random.default_rng(seed)
    state = jax.jit(jax.vmap(lambda k: jcv.reset(jcfg, k)))(
        jax.random.split(jax.random.key(seed), B))
    vstep = jax.jit(jax.vmap(lambda s, a: jcv.step(jcfg, s, a)))
    for _ in range(n_steps):
        state, _ = vstep(state, jnp.asarray(_actions(rng, B)))
    return state, vstep, rng


@pytest.mark.parametrize("options", [{}, {"strict_compat_raycast": False}],
                         ids=["default", "true_min"])
def test_step_matches_jax(options):
    jcfg, tcfg = jcv.CurvedEnvConfig(**options), tcv.CurvedEnvConfig(**options)
    B = 16
    jstate, _, rng = _warm_jax_states(jcfg, B, n_steps=3, seed=23)
    for _ in range(2):
        action = _actions(rng, B)
        tstate = curved_state_from_numpy(to_numpy(jstate), CPU)
        with jax.disable_jit():
            jnew, jts = jax.vmap(lambda s, a: jcv.step(jcfg, s, a))(jstate, jnp.asarray(action))
        tnew, tts = tcv.step(tcfg, tstate, torch.from_numpy(action))
        assert_timestep_close(tts, jts, atol=1e-5, info_tol=TOL)
        assert_state_close(tnew, to_numpy(jnew), **TOL)
        # the caller's state is a value: the step wrote into none of its leaves
        assert_state_close(tstate, to_numpy(jstate), atol=0, rtol=0)
        jstate = jnew
    assert len(tts.info) == 17
    assert (tts.obs[:, 9:] < 1.0).any()  # some ray sees an obstacle
    # the setpoint delta was taken against the previous setpoint
    delta = (tnew.last_setpoint - tstate.last_setpoint).abs().sum(-1)
    torch.testing.assert_close(tts.info["delta_action_reward"], -0.075 * delta, atol=1e-7, rtol=1e-5)


def test_terminations_match_jax():
    """One env per outcome: none, arrived (x past the last waypoint),
    collision (inside an obstacle's 0.05 m margin), off track (|ye| > 10),
    the time limit, and a masked obstacle on the boat (no collision)."""
    jcfg, tcfg = jcv.CurvedEnvConfig(), tcv.CurvedEnvConfig()
    B = 6
    jstate, _, _ = _warm_jax_states(jcfg, B, n_steps=2, seed=29)
    s = to_numpy(jstate)
    pose = s["dyn"]["pose"]
    s["obs_mask"][:] = False
    pose[1, 0] = s["waypoints"][1, -1, 0] + 0.5                    # arrived
    s["obs_xy"][2, 0] = pose[2, :2] + np.array([0.5, 0.0], np.float32)  # collision
    s["obs_r"][2, 0], s["obs_mask"][2, 0] = 0.6, True
    pose[3, 1] += 12.0                                              # off track
    s["step_count"][4] = jcfg.max_episode_steps - 1                 # time limit
    s["obs_xy"][5, 0] = pose[5, :2]                                 # masked: no collision
    jstate = from_numpy(jstate, s)
    action = np.zeros((B, 2), np.float32)
    _, jts = jax.vmap(lambda st, a: jcv.step(jcfg, st, a))(jstate, jnp.asarray(action))
    _, tts = tcv.step(tcfg, curved_state_from_numpy(s, CPU), torch.from_numpy(action))
    assert_timestep_close(tts, jts, atol=1e-5, info_tol=dict(atol=1e-4, rtol=1e-5))
    assert tts.terminated.tolist() == [False, True, True, True, False, False]
    assert tts.truncated.tolist() == [False, False, False, False, True, False]
    assert tts.info["arrived"].tolist() == [False, True, False, False, False, False]
    assert tts.info["collision"].tolist() == [False, False, True, False, False, False]
    assert float(tts.reward[2]) < -15.0 < float(tts.reward[0])


def test_multi_step_run_stays_close_to_jax():
    jcfg, tcfg = jcv.CurvedEnvConfig(), tcv.CurvedEnvConfig()
    B, T = 16, 15
    jstate, vstep, rng = _warm_jax_states(jcfg, B, n_steps=0, seed=37)
    tstate = curved_state_from_numpy(to_numpy(jstate), CPU)
    for _ in range(T):
        # throttle up with a little yaw, so that the boats get under way
        action = np.stack([rng.uniform(0.2, 1.0, B), rng.uniform(-0.3, 0.3, B)], 1).astype(np.float32)
        jstate, jts = vstep(jstate, jnp.asarray(action))
        tstate, tts = tcv.step(tcfg, tstate, torch.from_numpy(action))
        assert_timestep_close(tts, jts, atol=2e-4)
    assert float(np.asarray(jstate.dyn.vel)[:, 0].mean()) > 0.05  # under way after 0.75 s
    assert int(tstate.step_count[0]) == T


def test_config_carries_the_jax_fields():
    jcfg, tcfg = jcv.CurvedEnvConfig(), tcv.CurvedEnvConfig()
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tf = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    assert jf == tf
    assert (tcfg.obs_dim, tcfg.action_dim) == (jcfg.obs_dim, jcfg.action_dim) == (41, 2)
    assert tcfg.action_low == jcfg.action_low and tcfg.action_high == jcfg.action_high

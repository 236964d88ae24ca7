"""The port's gym surface (``usv_tpu_torch.compat``) against ``usv_tpu.compat``,
on the CPU.

* A counterpart of each test of ``tests/test_compat.py``, and gymnasium's
  ``check_env`` on the five classes ``tests/test_gym_check_env.py`` checks.
  The port's classes are registered under the prefix ``torch/``: the JAX
  package's may already hold the bare ids in this process.
* Step for step against the JAX adapters: every id with a replay of the
  reference's reset draws (``reference_reset_sampling=True``), from the same
  seeds, 64 scripted steps with episodes cut short so that both sides reset
  within the run (the next seed each time); ``usv-aitsmc-simple`` also with
  non-default gains (``options['params']``) and a perturbation function, the
  CA env also with its scripted-scene options. ``usv-curved-aitsmc`` has no
  replay: it starts each episode from the JAX adapter's reset state,
  converted. Obs and reward agree at 2e-4 (the port's bound for multi-step
  runs against jitted JAX: the ASMC and PID gains turn a heading's last bit
  into ~1e-4), flags and info keys are equal.
* Each reset option (``place_obstacles_on_path``, ``run_custom_experiment``,
  the CA scene), ``stale_reset_carryover`` (the carry, and the
  ``ValueError`` for the families without its fields, as JAX raises), and
  ``render()`` frames pixel for pixel against JAX's on equal states.
* The ``usv_libs_py`` stub against the port's native oracle, as
  ``tests/test_reference_ca_parity.py`` holds JAX's.
* Without CUDA the adapters raise unless given ``device="cpu"``; without
  gymnasium they construct, reset and step (a subprocess hides it).

The JAX adapters compile their steps, so the tests share them.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")
gymnasium = pytest.importorskip("gymnasium")

import jax.numpy as jnp  # noqa: E402
from gymnasium.utils.env_checker import check_env  # noqa: E402

from usv_tpu import compat as jcompat  # noqa: E402
from usv_tpu.control.aitsmc import AitsmcGains as JaxGains  # noqa: E402
from usv_tpu_torch import compat as tcompat  # noqa: E402
from usv_tpu_torch import convert  # noqa: E402
from usv_tpu_torch.control.aitsmc import AitsmcGains  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PREFIX = "torch/"
ATOL = 2e-4
STEPS = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: pytest-xdist may run several test processes on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _register():
    tcompat.register_gymnasium_envs(PREFIX)


_JAX_ENVS = {}


def jax_env(name, **kwargs):
    """A JAX adapter, made once per class and arguments in this module."""
    key = (name, repr(sorted(kwargs.items())))
    if key not in _JAX_ENVS:
        _JAX_ENVS[key] = getattr(jcompat, name)(render_mode="rgb_array", **kwargs)
    return _JAX_ENVS[key]


def torch_env(name, **kwargs):
    return getattr(tcompat, name)(render_mode="rgb_array", device="cpu", **kwargs)


def batched_numpy(state):
    """An unbatched JAX state as a nested dict of numpy arrays with a leading
    batch axis of 1, keys dropped."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name != "key":
            out[f.name] = batched_numpy(v) if dataclasses.is_dataclass(v) else np.asarray(v)[None]
    return out


CONVERTERS = {
    "usv-simple": convert.simple_state_from_numpy,
    "usv-asmc-simple": convert.simple_asmc_state_from_numpy,
    "usv-aitsmc-simple": convert.simple_aitsmc_state_from_numpy,
    "usv-asmc-ca-v0": convert.ca_state_from_numpy,
    "usv-curved-aitsmc": convert.curved_state_from_numpy,
    "usv-asmc-v0": convert.legacy_state_from_numpy,
    "usv-pid-v0": convert.legacy_state_from_numpy,
    "usv-asmc-ye-int-v0": convert.legacy_state_from_numpy,
}


def take_jax_state(tenv, jenv):
    """Carry the JAX adapter's state into the port's; returns the reset
    observation of it."""
    tenv._state = CONVERTERS[tenv.env_id](batched_numpy(jenv._state), CPU)
    return tenv.handle.reset_obs(tenv.handle.cfg, tenv._state)[0].numpy()


# -- counterparts of tests/test_compat.py -----------------------------------

def test_gym_make_simple():
    env = gymnasium.make(PREFIX + "usv-simple", device="cpu")
    obs, info = env.reset(seed=1)
    assert obs.shape == (143,) and obs.dtype == np.float32
    assert env.action_space.shape == (2,)
    np.testing.assert_allclose(env.action_space.low, [0.2, -1.0])
    total = 0.0
    for _ in range(10):
        obs, reward, terminated, truncated, info = env.step(np.zeros(2, np.float32))
        total += reward
    assert np.isfinite(total)
    env.close()


def test_reset_info_matches_reference_surface():
    """Reference reset returns ``_get_info(-1, np.zeros(3))``
    (simple_env.py:303-308): same keys as step info, reward=-1, zero
    action; the same keys as the JAX adapter's."""
    env = tcompat.UsvSimpleEnv(render_mode=None, device="cpu")
    obs, info = env.reset(seed=3)
    for key in ("position", "velocity", "path_start", "path_end", "reward",
                "action0", "action1", "left_thruster", "right_thruster",
                "ye", "angle_to_target"):
        assert key in info, key
    assert float(info["reward"]) == -1.0
    assert float(info["action0"]) == 0.0 and float(info["action1"]) == 0.0
    np.testing.assert_allclose(np.asarray(info["position"])[:2], np.asarray(info["path_start"]),
                               atol=1e-5)
    _, jinfo = jax_env("UsvSimpleEnv").reset(seed=3)
    assert sorted(info) == sorted(jinfo)
    for k, v in jinfo.items():
        assert info[k].shape == np.asarray(v).shape, k
    env.close()


def test_gym_time_limit_wrapping():
    for env_id, steps in (("usv-simple", 500), ("usv-asmc-simple", 1000), ("usv-aitsmc-simple", 150),
                          ("usv-asmc-ca-v0", 5000), ("usv-curved-aitsmc", 1000), ("usv-asmc-v0", None)):
        spec = gymnasium.spec(PREFIX + env_id)
        assert spec.max_episode_steps == steps == gymnasium.spec(env_id).max_episode_steps \
            if env_id in gymnasium.registry else spec.max_episode_steps == steps
        assert spec.entry_point.startswith("usv_tpu_torch.compat.gym_adapter:")
    env = gymnasium.make(PREFIX + "usv-simple", device="cpu")
    assert env.spec.max_episode_steps == 500
    assert isinstance(env.unwrapped, tcompat.UsvSimpleEnv)


def test_direct_class_reset_step():
    env = tcompat.UsvSimpleEnv(render_mode=None, device="cpu")
    obs, info = env.reset(seed=0)
    obs2, r, term, trunc, info = env.step(np.array([0.5, 0.1], np.float32))
    assert obs2.shape == (143,)
    assert isinstance(r, float) and isinstance(term, bool) and isinstance(trunc, bool)
    assert "ye" in info
    env.close()


EXPERIMENT = {
    "obstacle_positions": np.array([[10.0, 12.0], [8.0, 12.0]]),
    "obstacle_radius": np.array([1.5, 1.5]),
    "path_start": np.array([10.0, 4.0]),
    "angle": np.pi / 2,
    "position": np.array([10.0, 4.0, np.pi / 2]),
}


def test_custom_experiment_scene():
    """tools/test_env.py experiment_1-style scripted scene: the injected
    fields are JAX's exactly, and a run toward the wall sees it."""
    options = {"run_custom_experiment": True, "experiment": EXPERIMENT}
    env = tcompat.UsvSimpleEnv(render_mode=None, options={"run_custom_experiment": True}, device="cpu")
    obs, _ = env.reset(options=options)
    st = env._state
    np.testing.assert_allclose(st.position[0].numpy(), EXPERIMENT["position"])
    assert int(st.obs_mask.sum()) == 2
    jenv = jax_env("UsvSimpleEnv")
    jenv.reset(options=options)
    want = batched_numpy(jenv._state)
    for name in ("position", "obs_xy", "obs_r", "obs_mask", "path_start", "path_end"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), want[name], err_msg=name)
    seen = False
    for _ in range(40):
        obs, r, term, trunc, _ = env.step(np.array([1.0, 0.0], np.float32))
        seen |= bool((obs[15:] < 1.0).any())
        if term:
            break
    assert seen and int(env._state.obs_mask.sum()) == 2
    env.close()


def test_ca_env_adapter():
    env = tcompat.UsvAsmcCaEnv(render_mode=None, device="cpu")
    obs, info = env.reset(seed=3)
    assert obs.shape == (23,) and info == {}
    obs, r, term, trunc, info = env.step(np.array([0.2, 0.0], np.float32))
    assert np.isfinite(r)
    env.close()


CA_OPTIONS = {
    "obs_x": np.array([-6.0, 0.0, 6.0]),
    "obs_y": np.array([0.0, 0.0, 0.0]),
    "obs_r": np.array([1.5, 1.5, 1.5]),
    "start_position": np.array([0.0, -8.0, 0.0]),
    "target_point": np.array([0.0, 8.0, 0.0]),
    "renderplots": False,
}


def test_ca_env_scripted_options():
    """The scripted scene fixes everything a reset draws: the port's and
    JAX's resets agree (after the bootstrap step) and so do ten steps."""
    env = tcompat.UsvAsmcCaEnv(render_mode=None, device="cpu")
    obs, _ = env.reset(seed=0, options=CA_OPTIONS)
    st = env._state
    assert int(st.obs_mask.sum()) == 3
    np.testing.assert_allclose(st.target_point[0].numpy(), [0.0, 8.0])
    assert int(st.step_count) == 0 and int(st.perturb_step) == 0
    jenv = jax_env("UsvAsmcCaEnv")
    jobs, _ = jenv.reset(seed=7, options=CA_OPTIONS)
    np.testing.assert_allclose(obs, jobs, atol=ATOL, rtol=0)
    for t in range(10):
        a = np.array([0.5, 0.3], np.float32)
        got, want = env.step(a), jenv.step(a)
        np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0, err_msg=f"step {t}")
        assert abs(got[1] - want[1]) <= ATOL
    env.close()


def test_legacy_adapter_old_gym_api():
    env = tcompat.UsvAsmcEnv(render_mode=None, device="cpu")
    obs = env.reset(seed=5)  # legacy: obs only
    assert isinstance(obs, np.ndarray) and obs.shape == (6,)
    out = env.step(np.zeros(1, np.float32))
    assert len(out) == 4  # old-gym 4-tuple
    env.close()


def test_rgb_array_render():
    env = tcompat.UsvSimpleEnv(render_mode="rgb_array", device="cpu")
    env.reset(seed=7)
    frame = env.render()
    assert frame.shape == (512, 512, 3) and frame.dtype == np.uint8
    env.close()
    env = tcompat.UsvSimpleEnv(render_mode=None, device="cpu")
    env.reset(seed=7)
    assert env.render() is None


def test_vector_env_adapter():
    venv = tcompat.UsvVectorEnv("usv-simple", num_envs=8, frame_stack=2, device="cpu")
    obs, info = venv.reset(seed=3)
    assert obs.shape == (8, 2 * 143) and obs.dtype == np.float32 and info == {}
    assert venv.action_space.shape == (8, 2)
    assert venv.observation_space.shape == (8, 2 * 143)
    actions = np.zeros((8, 2), np.float32)
    for _ in range(3):
        obs, rewards, terminated, truncated, infos = venv.step(actions)
    assert obs.shape == (8, 2 * 143)
    assert rewards.shape == (8,) and rewards.dtype == np.float32
    assert terminated.dtype == bool and truncated.dtype == bool
    assert infos["terminal_observation"].shape == (8, 143)
    # gymnasium-conventional key + SameStep autoreset declaration
    assert infos["final_obs"].shape == (8, 143)
    assert venv.metadata == jcompat.UsvVectorEnv.metadata
    assert venv.metadata["autoreset_mode"] == "SameStep"
    jvenv = jcompat.UsvVectorEnv("usv-simple", num_envs=8, frame_stack=2)
    jvenv.reset(seed=3)
    jout = jvenv.step(actions)
    assert sorted(infos) == sorted(jout[4])
    for k, v in jout[4].items():
        assert infos[k].shape == v.shape and infos[k].dtype == v.dtype, k
    assert venv.single_observation_space == jvenv.single_observation_space
    assert venv.single_action_space == jvenv.single_action_space
    # reset(seed) goes through BatchedEnv.reset(seed): one seed, one batch
    a, _ = venv.reset(seed=11)
    b, _ = tcompat.UsvVectorEnv("usv-simple", num_envs=8, frame_stack=2, device="cpu").reset(seed=11)
    np.testing.assert_array_equal(a, b)
    venv.close()
    jvenv.close()


def test_vector_env_auto_resets_in_the_same_step():
    """An episode cut at 3 steps: the obs of the done step is the next
    episode's reset obs, the finished episode's last obs is in the infos."""
    venv = tcompat.UsvVectorEnv("usv-asmc-ca-v0", num_envs=4, device="cpu", max_episode_steps=3)
    venv.reset(seed=0)
    for t in range(3):
        obs, rewards, terminated, truncated, infos = venv.step(np.zeros((4, 2), np.float32))
    assert truncated.all() and not np.array_equal(obs, infos["final_obs"])
    np.testing.assert_array_equal(infos["final_obs"], infos["terminal_observation"])
    venv.close()


def test_legacy_render_smoke():
    env = tcompat.UsvAsmcEnv(render_mode="rgb_array", device="cpu")
    env.reset(seed=1)
    env.step(np.asarray([0.2], np.float32))
    frame = env.render()
    assert frame.shape == (512, 512, 3) and frame.dtype == np.uint8
    env.close()


# -- tests/test_gym_check_env.py --------------------------------------------

@pytest.mark.parametrize("name", ["UsvSimpleEnv", "UsvSimpleASMCEnv", "UsvSimpleAITSMCEnv",
                                  "UsvAsmcCaEnv", "UsvCurvedAitsmcEnv"])
def test_check_env(name):
    env = torch_env(name)
    try:
        check_env(env, skip_render_check=True)
    finally:
        env.close()


# -- step for step against the JAX adapters ---------------------------------

def _jax_perturb(step):
    s = step.astype(jnp.float32)
    return jnp.stack([2.0 * jnp.sin(0.3 * s), 1.5 * jnp.cos(0.2 * s), 0.2 * jnp.sin(0.1 * s)])


def _torch_perturb(step):
    s = step.to(torch.float32)
    return torch.stack([2.0 * torch.sin(0.3 * s), 1.5 * torch.cos(0.2 * s),
                        0.2 * torch.sin(0.1 * s)], dim=-1)


GAINS = dict(k_u=0.15, k_r=0.25, mu_u=0.04, lambda_r=0.12)
SHORT = {"max_episode_steps": 24}
# (class, JAX kwargs, port kwargs, reset options)
CASES = {
    "usv-simple": ("UsvSimpleEnv", SHORT, SHORT, None),
    "usv-asmc-simple": ("UsvSimpleASMCEnv", SHORT, SHORT, None),
    "usv-aitsmc-simple": ("UsvSimpleAITSMCEnv", SHORT, SHORT, None),
    "usv-aitsmc-simple, params and perturb_func": (
        "UsvSimpleAITSMCEnv",
        dict(SHORT, options={"params": JaxGains(**GAINS), "perturb_func": _jax_perturb}),
        dict(SHORT, options={"params": AitsmcGains(**GAINS), "perturb_func": _torch_perturb}),
        None),
    "usv-asmc-ca-v0": ("UsvAsmcCaEnv", SHORT, SHORT, None),
    "usv-asmc-ca-v0, scripted scene": ("UsvAsmcCaEnv", SHORT, SHORT, CA_OPTIONS),
    "usv-curved-aitsmc": ("UsvCurvedAitsmcEnv", SHORT, SHORT, None),
    # no TimeLimit in the legacy envs: a cross-track bound of 0.5 m ends episodes
    "usv-asmc-v0": ("UsvAsmcEnv", {"max_ye": 0.5}, {"max_ye": 0.5}, None),
    "usv-pid-v0": ("UsvPidEnv", {"max_ye": 0.5}, {"max_ye": 0.5}, None),
    "usv-asmc-ye-int-v0": ("UsvAsmcYeIntEnv", {"max_ye": 0.5}, {"max_ye": 0.5}, None),
}


def run_pair(jenv, tenv, steps, seed, options=None, rng_seed=0, reset_first=True):
    """Both adapters reset from ``seed`` (unless ``reset_first`` is False)
    and stepped with the same scripted actions; when an episode ends both
    reset from the next seed. Returns the number of episode ends."""
    replay = tenv.reference_reset_sampling
    rng = np.random.default_rng(rng_seed)
    low, high = jenv.action_space.low, jenv.action_space.high

    def reset(s):
        jo, to = jenv.reset(seed=s, options=options), tenv.reset(seed=s, options=options)
        if not tenv.legacy_api:
            (jo, jinfo), (to, tinfo) = jo, to
            assert sorted(tinfo) == sorted(jinfo)
        if not replay:
            to = take_jax_state(tenv, jenv)
        np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0, err_msg=f"reset from seed {s}")

    if reset_first:
        reset(seed)
    ends = 0
    for t in range(steps):
        a = rng.uniform(low, high).astype(np.float32)
        want, got = jenv.step(a), tenv.step(a)
        assert len(got) == len(want) == (4 if tenv.legacy_api else 5)
        np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0, err_msg=f"step {t}")
        assert got[0].shape == want[0].shape and got[0].dtype == np.float32
        assert isinstance(got[1], float) and abs(got[1] - want[1]) <= ATOL, f"step {t}"
        assert got[2:-1] == want[2:-1], f"step {t}: flags {got[2:-1]} against {want[2:-1]}"
        assert all(isinstance(f, bool) for f in got[2:-1])
        assert sorted(got[-1]) == sorted(want[-1]), f"step {t}"
        if any(got[2:-1]):
            ends += 1
            reset(seed + ends)
    return ends


@pytest.mark.parametrize("case", sorted(CASES))
def test_episodes_match_the_jax_adapter(case):
    name, jkw, tkw, options = CASES[case]
    replay = name != "UsvCurvedAitsmcEnv"
    jenv = jax_env(name, reference_reset_sampling=replay, **jkw)
    tenv = torch_env(name, reference_reset_sampling=replay, **tkw)
    ends = run_pair(jenv, tenv, STEPS, seed=5, options=options)
    assert ends >= 1, f"{case}: no episode end in {STEPS} steps"
    tenv.close()


def test_place_obstacles_on_path_rebuilds_the_handle():
    """The option applies to the resets that pass it: the handle is rebuilt
    with that many path obstacles, the replayed scene holds them (JAX's
    scene), and a reset without it goes back."""
    jenv = jax_env("UsvSimpleEnv", reference_reset_sampling=True)
    tenv = torch_env("UsvSimpleEnv", reference_reset_sampling=True)
    run_pair(jenv, tenv, 8, seed=5, options={"place_obstacles_on_path": 3})
    assert tenv.handle.cfg.path_obstacles == 3 and tenv.handle.n_uniform(tenv.handle.cfg) == 16 + 96 + 9
    want = batched_numpy(jenv._state)
    np.testing.assert_array_equal(tenv._state.obs_mask.numpy(), want["obs_mask"])
    np.testing.assert_array_equal(tenv._state.obs_xy.numpy(), want["obs_xy"])
    tenv.reset(seed=6)
    assert tenv.handle.cfg.path_obstacles == 0
    # given to the constructor, it applies to every reset
    env = torch_env("UsvSimpleEnv", options={"place_obstacles_on_path": 2})
    env.reset(seed=1)
    assert env.handle.cfg.path_obstacles == 2
    env.reset(seed=2)
    assert env.handle.cfg.path_obstacles == 2 and env._state.obs_mask[0, -2:].all()


def test_stale_reset_carryover_matches_jax():
    """The reused instance's next episode starts from the last one's sensor
    readings and smoothed action (the reference quirk): the reset obs and
    the steps after it are JAX's."""
    jenv = jax_env("UsvSimpleEnv", reference_reset_sampling=True, stale_reset_carryover=True)
    tenv = torch_env("UsvSimpleEnv", reference_reset_sampling=True, stale_reset_carryover=True)
    run_pair(jenv, tenv, 12, seed=5)
    last = tenv._state
    assert bool(last.sensor_dist.any()) and bool(last.last_action.any())
    (jo, _), (to, _) = jenv.reset(seed=11), tenv.reset(seed=11)
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)
    assert torch.equal(tenv._state.sensor_dist, last.sensor_dist)
    assert torch.equal(tenv._state.last_action, last.last_action)
    run_pair(jenv, tenv, 12, seed=11, reset_first=False)
    # without the flag the reset is fresh
    fresh = torch_env("UsvSimpleEnv", reference_reset_sampling=True)
    fresh.reset(seed=5)
    fresh.step(np.array([0.5, 0.1], np.float32))
    fresh.reset(seed=11)
    assert not bool(fresh._state.sensor_dist.any()) and not bool(fresh._state.last_action.any())
    for name in ("UsvSimpleASMCEnv", "UsvSimpleAITSMCEnv"):
        env = torch_env(name, stale_reset_carryover=True)
        env.reset(seed=0)
        env.step(np.array([0.5, 0.1], np.float32))
        carried = env._state.base.sensor_dist
        env.reset(seed=1)
        assert torch.equal(env._state.base.sensor_dist, carried)


@pytest.mark.parametrize("name", ["UsvAsmcCaEnv", "UsvCurvedAitsmcEnv", "UsvAsmcEnv", "UsvPidEnv",
                                  "UsvAsmcYeIntEnv"])
def test_stale_reset_carryover_refuses_other_families(name):
    with pytest.raises(ValueError, match="stale_reset_carryover is not supported") as got:
        torch_env(name, stale_reset_carryover=True)
    with pytest.raises(ValueError) as want:
        getattr(jcompat, name)(render_mode=None, stale_reset_carryover=True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["UsvSimpleEnv", "UsvAsmcCaEnv", "UsvCurvedAitsmcEnv", "UsvAsmcEnv"])
def test_render_frames_equal_jax_on_equal_states(name):
    """The JAX adapter's state after a reset and three steps, carried into
    the port's adapter: ``render()`` gives JAX's frame pixel for pixel."""
    jenv = jax_env(name)
    tenv = torch_env(name)
    jenv.reset(seed=4)
    tenv.reset(seed=4)
    for _ in range(3):
        jenv.step(jenv.action_space.low * 0.5 + jenv.action_space.high * 0.5)
    take_jax_state(tenv, jenv)
    want, got = jenv.render(), tenv.render()
    assert got.shape == want.shape == (512, 512, 3) and got.dtype == np.uint8
    assert np.array_equal(got, want), f"{int((got != want).any(-1).sum())} pixels differ"
    tenv.close()


def test_same_seed_same_scene_and_fresh_seeds_differ():
    env = torch_env("UsvSimpleEnv")
    a, _ = env.reset(seed=9)
    b, _ = torch_env("UsvSimpleEnv").reset(seed=9)
    np.testing.assert_array_equal(a, b)
    c, _ = env.reset()
    d, _ = env.reset()
    assert not np.array_equal(c, d)


# -- the usv_libs_py stub ----------------------------------------------------

def test_usv_libs_stub_substep_driver_matches_native_compute():
    """The stub's update_controller_and_model_n against the port's native
    oracle's fused n-substep driver, with the binding's history fields
    (tests/test_reference_ca_parity.py:270-300)."""
    native = pytest.importorskip("usv_tpu_torch.native", reason="the native oracle needs g++")
    from usv_tpu_torch.compat import usv_libs_stub as stub

    m1 = stub.DynamicModel(1.0, -2.0, 0.3)
    a1 = stub.ASMC(stub.ASMC.defaultParams())
    sp = stub.ASMCSetpoint()
    sp.velocity, sp.heading = 0.7, 0.4
    mh, ch = stub.update_controller_and_model_n(m1, a1, sp, 10)
    assert len(mh) == len(ch) == 10

    m2 = native.DynamicModel(1.0, -2.0, 0.3)
    a2 = native.ASMC()
    pose2, vel2 = a2.compute(m2, 0.7, 0.4, n=10, absolute_heading=True)

    np.testing.assert_allclose([mh[-1].pose_x, mh[-1].pose_y, mh[-1].pose_psi], pose2, atol=1e-12)
    np.testing.assert_allclose([mh[-1].vel_x, mh[-1].vel_y, mh[-1].vel_r], vel2, atol=1e-12)
    for field in ("left_thruster", "right_thruster", "speed_error",
                  "heading_error", "speed_gain", "heading_gain",
                  "speed_sigma", "heading_sigma", "Tx", "Tz"):
        assert hasattr(ch[-1], field), field
    l, r = ch[-1].left_thruster, ch[-1].right_thruster
    np.testing.assert_allclose(ch[-1].Tx, l + 0.78 * r, atol=1e-12)
    np.testing.assert_allclose(ch[-1].Tz, 0.5 * 0.41 * (l - 0.78 * r), atol=1e-12)


def test_install_usv_libs_py_and_the_aitsmc_surface():
    pytest.importorskip("usv_tpu_torch.native", reason="the native oracle needs g++")
    from usv_tpu_torch.compat import usv_libs_stub as stub

    saved = {k: sys.modules.get(k) for k in ("usv_libs_py", "usv_libs_py.controller",
                                             "usv_libs_py.model", "usv_libs_py.utils")}
    try:
        libs = tcompat.install_usv_libs_py()
        import usv_libs_py

        assert usv_libs_py is libs and sys.modules["usv_libs_py.controller"].ASMC is stub.ASMC
        model = libs.model.DynamicModel(0.0, 0.0, 0.0)
        ctrl = libs.controller.AITSMC(libs.controller.AITSMC.defaultParams())
        sp = libs.controller.AITSMCSetpoint()
        sp.u, sp.r = 0.6, 0.1
        for _ in range(5):
            out = ctrl.update(libs.utils.from_model(model), sp)
            state = model.update_with_perturb(out.left_thruster, out.right_thruster, [0.1, 0.0, 0.0])
        dbg = ctrl.getDebugData()
        assert {"e_u", "e_r", "Ka_u", "Ka_r"} <= set(vars(dbg)) and state.u > 0
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


# -- devices and gymnasium ---------------------------------------------------

def test_adapters_default_to_the_card_and_raise_without_it():
    if torch.cuda.is_available():
        assert tcompat.UsvSimpleEnv().device.type == "cuda"
        return
    for make in (tcompat.UsvSimpleEnv, tcompat.UsvAsmcEnv, tcompat.UsvVectorEnv,
                 lambda: gymnasium.make(PREFIX + "usv-simple")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


_NO_GYMNASIUM = r"""
import sys
sys.modules["gymnasium"] = None
import numpy as np
from usv_tpu_torch.compat import UsvAsmcEnv, UsvSimpleEnv, UsvVectorEnv, register_gymnasium_envs
from usv_tpu_torch.compat import gym_adapter
assert not gym_adapter._HAS_GYMNASIUM and gym_adapter.GymUsvEnv.__bases__ == (object,)

env = UsvSimpleEnv(device="cpu", reference_reset_sampling=True)
assert not hasattr(env, "observation_space")
obs, info = env.reset(seed=3)
assert obs.shape == (143,) and info["reward"] == -1.0
obs, reward, terminated, truncated, info = env.step(np.array([0.5, 0.1], np.float32))
assert obs.shape == (143,) and isinstance(reward, float)
legacy = UsvAsmcEnv(device="cpu")
assert legacy.reset(seed=1).shape == (6,) and len(legacy.step(np.zeros(1, np.float32))) == 4

venv = UsvVectorEnv("usv-simple", 4, frame_stack=2, device="cpu")
assert not hasattr(venv, "observation_space")
obs, _ = venv.reset(seed=1)
obs, rewards, terminated, truncated, infos = venv.step(np.zeros((4, 2), np.float32))
assert obs.shape == (4, 286) and rewards.shape == (4,) and infos["final_obs"].shape == (4, 143)
venv.close()
try:
    register_gymnasium_envs()
except ImportError:
    print("ok")
"""


def test_adapters_run_without_gymnasium():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _NO_GYMNASIUM], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

"""The port's serving path — ``train/policy.py``, ``train/evaluate.py``,
``train/run_eval.py``, ``train/metrics.py``, ``utils/numpy_policy.py`` —
against the JAX package, on the CPU.

* Bundles: a saved bundle reloads to the same actions bit for bit; its
  ``policy.json`` has the JAX package's keys; an ``.npz`` in the layout of
  the JAX package's ``export_numpy_policy`` loads into the port and gives the
  JAX ``Policy``'s actions at atol=1e-5; the port's own export is read by
  both numpy-only loaders.
* ``batch_policy_metrics``'s loop (``run_batch``) and ``rollout_with_info``
  against the JAX bodies from the same converted initial states, over a
  window with no episode end: stacked obs, actions and the reward sum at
  atol=2e-4 (the multi-step bound of the env tests: each side evolves on its
  own and the JAX side runs jitted).
* The whole slice as one test: a converted gSDE SAC actor drives
  ``BatchedEnv("usv-curved-aitsmc", frame_stack=5)`` against the JAX
  ``batch_policy_metrics`` body.
* The CLI writes its summary and figure on the CPU, and with ``--video`` an
  episode video of the bundle's policy.
"""

import dataclasses
import json
import sys
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")

from usv_tpu import envs as jenvs
from usv_tpu.envs.autoreset import make_autoreset_step as jax_autoreset_step
from usv_tpu.models import mlp as jmlp
from usv_tpu.train import metrics as jmetrics
from usv_tpu.train.policy import Policy as JaxPolicy
from usv_tpu.utils import numpy_policy as jnumpy_policy
from usv_tpu.vector import frames as jframes
from usv_tpu_torch import convert
from usv_tpu_torch import envs as tenvs
from usv_tpu_torch.models import mlp as tmlp
from usv_tpu_torch.train import evaluate, metrics, policy as tpolicy, run_eval
from usv_tpu_torch.utils import numpy_policy
from usv_tpu_torch.vector import BatchedEnv, BatchState, init_frames

STACK = 5
HIDDEN = (32, 24)
JAX_META_KEYS = {
    "sac": {"kind", "obs_dim", "action_dim", "hidden", "log_std_init", "action_low",
            "action_high", "use_sde", "frame_stack", "compute_dtype"},
    "ppo": {"kind", "obs_dim", "action_dim", "pi_hidden", "vf_hidden", "log_std_init",
            "action_low", "action_high", "use_sde", "frame_stack", "compute_dtype"},
}
CONVERTERS = {
    "usv-simple": convert.simple_state_from_numpy,
    "usv-asmc-ca-v0": convert.ca_state_from_numpy,
    "usv-curved-aitsmc": convert.curved_state_from_numpy,
}


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


def jax_policy(kind, env_id, seed, use_sde=True):
    """A JAX ``Policy`` with seeded, perturbed flax params, and its metadata."""
    cfg = jenvs.make(env_id).cfg
    obs_dim = STACK * cfg.obs_dim
    meta = dict(kind=kind, obs_dim=obs_dim, action_dim=cfg.action_dim, log_std_init=-3.0,
                action_low=[float(v) for v in cfg.action_low],
                action_high=[float(v) for v in cfg.action_high],
                use_sde=use_sde, frame_stack=STACK, compute_dtype="float32")
    if kind == "sac":
        meta["hidden"] = list(HIDDEN)
        net = jmlp.SquashedGaussianActor(
            action_dim=cfg.action_dim, hidden=HIDDEN, action_low=tuple(meta["action_low"]),
            action_high=tuple(meta["action_high"]), use_sde=use_sde)
    else:
        meta["pi_hidden"], meta["vf_hidden"] = list(HIDDEN), list(HIDDEN)
        net = jmlp.PpoActorCritic(action_dim=cfg.action_dim, pi_hidden=HIDDEN, vf_hidden=HIDDEN,
                                  log_std_init=-3.0, use_sde=use_sde)
    params = net.init(jax.random.key(seed), jnp.zeros((1, obs_dim)))
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    params = jax.tree.unflatten(tree, [
        leaf + 0.1 * jnp.asarray(rng.standard_normal(leaf.shape), jnp.float32) for leaf in leaves])
    return JaxPolicy(meta, params), meta


def write_jax_npz(jpolicy, path):
    """What ``usv_tpu.train.policy.export_numpy_policy`` writes for this
    policy (its body after the orbax load)."""
    np.savez(path, __meta__=np.asarray(json.dumps(jpolicy.meta)), **flatten(jpolicy.params))
    return str(path)


@pytest.mark.parametrize("kind,env_id", [("sac", "usv-simple"), ("ppo", "usv-asmc-ca-v0")])
def test_jax_export_loads_and_bundle_round_trips(kind, env_id, tmp_path):
    jpolicy, meta = jax_policy(kind, env_id, seed=1)
    npz = write_jax_npz(jpolicy, tmp_path / "policy_np.npz")
    # the JAX package's numpy loader reads the file: it is that layout
    jnp_policy = jnumpy_policy.load_numpy_policy(npz)

    served = tpolicy.load_policy(npz, device="cpu")          # the file
    from_dir = tpolicy.load_policy(tmp_path, device="cpu")   # a directory that holds it
    assert served.frame_stack == STACK and served.obs_dim == meta["obs_dim"]
    obs = np.random.default_rng(2).standard_normal((7, meta["obs_dim"])).astype(np.float32)
    want = np.asarray(jpolicy(obs))
    got = served(obs)
    assert isinstance(got, torch.Tensor) and got.shape == (7, meta["action_dim"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(jnp_policy(obs), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(from_dir(obs), got)
    # a single observation, as a control loop hands it over
    np.testing.assert_allclose(served(obs[0]).numpy(), np.asarray(jpolicy(obs[0])), atol=1e-5)
    assert served(torch.from_numpy(obs[0])).shape == (meta["action_dim"],)
    low, high = torch.tensor(meta["action_low"]), torch.tensor(meta["action_high"])
    assert ((got >= low) & (got <= high)).all()
    assert not got.requires_grad

    # saved by the port, reloaded: the same actions bit for bit
    bundle = tpolicy.save_policy(served.meta, served.module, tmp_path / "bundle")
    assert sorted(p.name for p in (tmp_path / "bundle").iterdir()) == ["params.pt", "policy.json"]
    saved_meta = json.loads((tmp_path / "bundle" / "policy.json").read_text())
    assert set(saved_meta) == JAX_META_KEYS[kind] and saved_meta == meta
    reloaded = tpolicy.load_policy(bundle, device="cpu")
    assert torch.equal(reloaded(obs), got)
    for (ka, va), (kb, vb) in zip(sorted(reloaded.module.state_dict().items()),
                                  sorted(served.module.state_dict().items())):
        assert ka == kb and torch.equal(va, vb)

    # the port's export is the same layout: both numpy-only loaders serve it
    exported = tpolicy.export_numpy_policy(bundle)
    assert exported == str(tmp_path / "bundle" / "policy_np.npz")
    with np.load(exported) as a, np.load(npz) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for loader in (numpy_policy.load_numpy_policy, jnumpy_policy.load_numpy_policy):
        np_policy = loader(exported)
        np.testing.assert_allclose(np_policy(obs), got.numpy(), atol=1e-5, rtol=1e-5)
        assert np_policy(obs[0]).shape == (meta["action_dim"],)
    assert torch.equal(tpolicy.load_policy(exported, device="cpu")(obs), got)


def test_module_meta_and_ppo_clip():
    cfg = tenvs.make("usv-simple", device="cpu").cfg
    actor = tmlp.SquashedGaussianActor(STACK * cfg.obs_dim, 2, HIDDEN, action_low=cfg.action_low,
                                       action_high=cfg.action_high, use_sde=True)
    meta = tpolicy.module_meta(actor, STACK)
    assert set(meta) == JAX_META_KEYS["sac"]
    np.testing.assert_allclose(meta["action_low"], [0.2, -1.0])
    json.dumps(meta)  # plain Python values only
    rebuilt = tpolicy.build_module(meta)
    assert sorted(rebuilt.state_dict()) == sorted(actor.state_dict())

    ppo = tmlp.PpoActorCritic(10, 2, HIDDEN, HIDDEN)
    with pytest.raises(ValueError, match="action_low"):
        tpolicy.module_meta(ppo, 1)
    meta = tpolicy.module_meta(ppo, 1, (-1.0, -1.0), (1.0, 1.0))
    assert set(meta) == JAX_META_KEYS["ppo"]
    with torch.no_grad():
        ppo.pi_mean.bias.copy_(torch.tensor([5.0, -5.0]))
    served = tpolicy.Policy(meta, ppo, device="cpu")
    out = served(np.zeros((3, 10), np.float32))
    assert (out == torch.tensor([1.0, -1.0])).all()  # the mean is clipped to the bounds
    with pytest.raises(TypeError):
        tpolicy.module_meta(torch.nn.Linear(2, 2), 1)
    with pytest.raises(ValueError, match="kind"):
        tpolicy.build_module({"kind": "dqn"})


def test_load_policy_device_and_missing_files(tmp_path):
    jpolicy, _ = jax_policy("sac", "usv-simple", seed=3)
    npz = write_jax_npz(jpolicy, tmp_path / "policy_np.npz")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpolicy.load_policy(npz)  # the card unless the caller names another device
    with pytest.raises(FileNotFoundError):
        tpolicy.load_policy(tmp_path / "nothing_here", device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tpolicy.load_policy(tmp_path / "empty", device="cpu")


def _jax_rollout(env_id, jpolicy, num_envs, n_steps, seed):
    """The body of ``usv_tpu.train.evaluate.batch_policy_metrics``, with the
    initial state and every step's stacked obs, actions and sums kept."""
    handle = jenvs.make(env_id)
    cfg = handle.cfg
    auto = jax.jit(jax.vmap(jax_autoreset_step(cfg, handle.step, handle.reset, handle.reset_obs)))
    state0 = jax.vmap(lambda k: handle.reset(cfg, k))(
        jax.random.split(jax.random.key(seed + 1), num_envs))
    obs0 = jax.vmap(lambda s: handle.reset_obs(cfg, s))(state0)
    state, frames = state0, jframes.init_frames(obs0, STACK)
    seen, acts, sums = [], [], {"reward": 0.0, "done": 0, "terminated": 0}
    for _ in range(n_steps):
        stacked = frames.reshape(num_envs, -1)
        actions = jpolicy(stacked)
        state, ts = auto(state, actions)
        frames = jframes.push_frames(frames, ts.obs, ts.done)
        seen.append(np.asarray(stacked))
        acts.append(np.asarray(actions))
        sums["reward"] += float(jnp.sum(ts.reward))
        sums["done"] += int(jnp.sum(ts.done))
        sums["terminated"] += int(jnp.sum(ts.terminated))
        for k, v in ts.info.items():
            if v.dtype == jnp.bool_ and v.ndim == 1:
                sums["info_" + k] = sums.get("info_" + k, 0) + int(jnp.sum(v))
    return state0, np.asarray(obs0), seen, acts, sums


@pytest.mark.parametrize("kind,env_id", [
    ("ppo", "usv-asmc-ca-v0"), ("sac", "usv-simple"), ("sac", "usv-curved-aitsmc")])
def test_batch_policy_rollout_matches_jax(kind, env_id, tmp_path):
    """The slice end to end: weights through the converter, the JAX reset's
    state through the state converter, then ``run_batch`` over
    ``BatchedEnv(frame_stack=5)`` against the JAX loop."""
    B, T = 8, 10
    jpolicy, _ = jax_policy(kind, env_id, seed=5)
    served = tpolicy.load_policy(write_jax_npz(jpolicy, tmp_path / "policy_np.npz"), device="cpu")
    state0, obs0, seen, acts, jsums = _jax_rollout(env_id, jpolicy, B, T, seed=0)
    assert jsums["done"] == 0  # the window holds no episode end: no fresh draw is selected

    handle = tenvs.make(env_id, device="cpu")
    benv = BatchedEnv(handle, B, frame_stack=STACK)
    benv.reset(0)  # gives the batch its generator; the state comes from JAX
    env_state = CONVERTERS[env_id](to_numpy(state0), "cpu")
    tobs0 = handle.reset_obs(handle.cfg, env_state)
    np.testing.assert_allclose(tobs0.numpy(), obs0, atol=1e-5)
    state = BatchState(env=env_state, frames=init_frames(tobs0, STACK))

    tseen, tacts = [], []

    def recording(stacked):
        actions = served(stacked)
        tseen.append(stacked.numpy().copy())
        tacts.append(actions.numpy().copy())
        return actions

    state, sums = evaluate.run_batch(benv, state, recording, T)
    for t in range(T):
        np.testing.assert_allclose(tseen[t], seen[t], atol=2e-4, rtol=0, err_msg=f"obs, step {t}")
        np.testing.assert_allclose(tacts[t], acts[t], atol=2e-4, rtol=0, err_msg=f"actions, step {t}")
    got = evaluate.metrics_from_sums(sums, T, B)
    assert got["reward_per_step"] * T * B == pytest.approx(jsums["reward"], abs=2e-4 * T * B)
    assert got["episodes_finished"] == 0 and got["terminations"] == 0 and got["truncations"] == 0
    flags = {k for k in jsums if k.startswith("info_")}
    assert {k for k in got if k.startswith("info_")} == flags
    if env_id != "usv-simple":
        assert flags == {"info_arrived", "info_collision"}
    assert all(isinstance(got[k], int) for k in flags)
    assert state.frames.shape == (B, STACK, handle.cfg.obs_dim)


def test_batch_policy_metrics_counts_episode_ends():
    handle = tenvs.make("usv-asmc-ca-v0", device="cpu", max_episode_steps=4)
    calls = []

    def zero_policy(stacked):
        calls.append(tuple(stacked.shape))
        return torch.zeros((stacked.shape[0], 2))

    got = evaluate.batch_policy_metrics(handle, zero_policy, n_steps=9, num_envs=6, seed=0,
                                        frame_stack=STACK)
    assert list(got)[:4] == ["reward_per_step", "episodes_finished", "terminations", "truncations"]
    assert got["episodes_finished"] == 12 and got["truncations"] == 12 - got["terminations"]
    assert "info_arrived" in got and "info_collision" in got
    assert calls == [(6, STACK * 23)] * 9
    assert np.isfinite(got["reward_per_step"])
    # seeded: the same call gives the same numbers; frame_stack 0 is a stack of one
    again = evaluate.batch_policy_metrics(handle, zero_policy, n_steps=9, num_envs=6, seed=0,
                                          frame_stack=STACK)
    assert again == got
    evaluate.batch_policy_metrics(handle, zero_policy, n_steps=1, num_envs=2, frame_stack=0)
    assert calls[-1] == (2, 23)


def test_rollout_with_info_matches_jax(tmp_path):
    from usv_tpu.train.evaluate import rollout_with_info as jax_rollout_with_info

    env_id, T, seed = "usv-simple", 12, 3
    jpolicy, _ = jax_policy("sac", env_id, seed=7)
    served = tpolicy.load_policy(write_jax_npz(jpolicy, tmp_path / "policy_np.npz"), device="cpu")
    jhandle = jenvs.make(env_id)
    want = jax_rollout_with_info(jhandle, jpolicy, n_steps=T, seed=seed, frame_stack=STACK)

    handle = tenvs.make(env_id, device="cpu")
    jstate = jhandle.reset(jhandle.cfg, jax.random.key(seed))
    one = jax.tree.map(lambda x: x[None], jstate)  # a batch of one
    env_state = CONVERTERS[env_id](to_numpy(one), "cpu")
    obs0 = handle.reset_obs(handle.cfg, env_state)
    start = BatchState(env=env_state, frames=init_frames(obs0, STACK))
    got = evaluate.rollout_with_info(handle, served, n_steps=T, seed=seed, frame_stack=STACK,
                                     initial_state=start)
    assert sorted(got) == sorted(want)
    assert not want["done"].any()
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if v.dtype == np.bool_:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, atol=2e-4, rtol=1e-5, err_msg=k)
    assert got["obs"].shape == (T, handle.cfg.obs_dim) and got["reward"].shape == (T,)
    # without an initial state the seeded reset is used; a policy may return numpy
    own = evaluate.rollout_with_info(handle, lambda obs: np.zeros(2, np.float32), n_steps=3, seed=1)
    assert own["position"].shape == (3, 3) and own["terminal_observation"].shape == (3, 143)


def test_run_eval_cli_on_the_cpu(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    jpolicy, _ = jax_policy("sac", "usv-curved-aitsmc", seed=9)
    npz = write_jax_npz(jpolicy, tmp_path / "policy_np.npz")
    out = tmp_path / "eval"
    run_eval.main(["--env", "usv-curved-aitsmc", "--policy", npz, "--out", str(out),
                   "--steps", "12", "--episodes", "4", "--seed", "2", "--device", "cpu"])
    summary = json.loads((out / "summary.json").read_text())
    assert summary["env"] == "usv-curved-aitsmc" and summary["policy"] == npz
    assert summary["steps"] == 12 and summary["episodes_batch"] == 4
    assert {"reward_per_step", "episodes_finished", "terminations", "truncations",
            "info_arrived", "info_collision"} <= set(summary)
    assert (out / "diagnostics.png").stat().st_size > 10_000
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[0]) == summary and "diagnostics.png" in printed[-1]

    # the zero-action baseline on a legacy id (a 1-D action)
    run_eval.main(["--env", "usv-pid-v0", "--out", str(tmp_path / "zero"), "--steps", "5",
                   "--episodes", "3", "--device", "cpu"])
    zero = json.loads((tmp_path / "zero" / "summary.json").read_text())
    assert zero["policy"] == "zero-action baseline" and zero["episodes_finished"] == 0

    # --video renders the bundle's episode on the host
    run_eval.main(["--env", "usv-curved-aitsmc", "--policy", npz, "--out", str(tmp_path / "video"),
                   "--steps", "6", "--episodes", "2", "--device", "cpu", "--video"])
    assert [p.stem for p in (tmp_path / "video").glob("episode.*")] == ["episode"]

    # --replay-recorded-eval needs a bundle, and one that records a seed
    with pytest.raises(SystemExit) as exc:
        run_eval.main(["--device", "cpu", "--replay-recorded-eval"])
    assert exc.value.code == 2
    assert "--policy" in capsys.readouterr().err
    with pytest.raises(ValueError, match="no recorded in-run eval"):
        run_eval.main(["--device", "cpu", "--replay-recorded-eval", "--policy", str(tmp_path),
                       "--out", str(tmp_path / "replay")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_eval.main(["--steps", "1", "--out", str(tmp_path / "card")])


def test_run_eval_cli_without_matplotlib(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    out = tmp_path / "eval"
    run_eval.main(["--env", "usv-simple", "--out", str(out), "--steps", "5", "--episodes", "2",
                   "--device", "cpu"])
    summary = json.loads((out / "summary.json").read_text())
    assert summary["steps"] == 5 and not (out / "diagnostics.png").exists()
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0] == "matplotlib is not installed: no diagnostics figure"
    assert json.loads(printed[1]) == summary and printed[-1] == f"wrote {out / 'summary.json'}"


def test_bundle_eval_and_in_run_eval_meta(tmp_path):
    jpolicy, _ = jax_policy("ppo", "usv-asmc-ca-v0", seed=11)
    npz = write_jax_npz(jpolicy, tmp_path / "policy_np.npz")
    plain = evaluate.bundle_eval("usv-asmc-ca-v0", npz, steps=4, episodes=3, device="cpu")
    assert list(plain) == ["reward_per_step"]
    rates = evaluate.bundle_eval("usv-asmc-ca-v0", npz, best_metric="arrivals", steps=4,
                                 episodes=3, device="cpu")
    assert rates["reward_per_step"] == plain["reward_per_step"]
    assert rates["arrival_rate"] == 0 and rates["collision_rate"] == 0

    block = tpolicy.in_run_eval_meta("usv-asmc-ca-v0", "arrivals", np.float32(0.5),
                                     {"reward_per_step": np.float32(1.5), "arriveds": 3},
                                     eval_seed=17, n_steps=100, num_envs=8)
    rec = block["in_run_eval"]
    assert rec == dict(env="usv-asmc-ca-v0", best_metric="arrivals", score=0.5,
                       stats={"reward_per_step": 1.5, "arriveds": 3.0}, n_steps=100, num_envs=8,
                       seed=17)
    served = tpolicy.load_policy(npz, device="cpu")
    bundle = tpolicy.save_policy(served.meta, served.module, tmp_path / "best", extra_meta=block)
    assert tpolicy.load_policy(bundle, device="cpu").meta["in_run_eval"] == rec


def test_metrics_module_matches_jax(tmp_path):
    for stats, best in [({"reward_per_step": 1.25}, "reward"),
                        ({"reward_per_step": 0.5, "arriveds": 3.0, "episodes": 4.0}, "arrivals"),
                        ({"reward_per_step": 0.5, "arriveds": 3.0, "collisions": 1.0,
                          "episodes": 0.0}, "arrivals"),
                        ({"reward_per_step": 0.5, "arriveds": 3.0, "episodes": 4.0}, "reward")]:
        assert metrics.score_eval_stats(stats, best) == jmetrics.score_eval_stats(stats, best)
    logger = metrics.MetricLogger(tmp_path / "log", use_tensorboard=False, config={"lr": 3e-4})
    logger.log(10, reward=1.5, note="x")
    logger.log(20, reward=2.5)
    logger.close()
    lines = [json.loads(line) for line in (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [line["step"] for line in lines] == [10, 20] and lines[0]["reward"] == 1.5
    assert json.loads((tmp_path / "log" / "config.json").read_text()) == {"lr": "0.0003"}

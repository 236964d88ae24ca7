"""The port's measurement tools (``usv_tpu_torch/tools/bench_*.py``,
``scaling_check.py``, ``reference_protocol_bench.py``) against the JAX
package's repo-root scripts, on the CPU at tiny sizes.

Each JAX script runs in process with its timed core stubbed where a JAX
compile would dominate (``throughput``, the learners, ``jax.jit``, the host
loop), so that it prints its own JSON keys and row labels; the port's tool
runs for real with ``--device cpu``. Held:

* the printed keys and the ``env``/``config``/``mode`` labels equal JAX's,
  with ``device`` added to every summary or artifact the port writes;
* ``scaling_check.predict``'s rows equal JAX's exactly;
* ``bench_policy``'s chained output (``last[-1]``) equals JAX's for the
  same weights (``convert.state_dict_from_flax``) at batch 8, chain 8;
* ``bench_train``'s ``optimizer_steps_per_iter`` and the SAC updates a round
  equal JAX's;
* ``bench_step_anatomy``'s ``raw`` and ``autoreset`` final states equal the
  env's step loop and ``BatchedEnv``'s bit for bit (B=8, T=4);
* ``ignore_obstacles`` casts no ray and its steps equal the cast-and-
  overwrite form bit for bit (20 steps of the three simple-family ids);
* every tool raises without CUDA unless ``--device cpu`` is given, and no
  new port module loads ``jax``, ``flax`` or ``usv_tpu``.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usv_tpu_torch.envs import make
from usv_tpu_torch.envs import simple as torch_simple
from usv_tpu_torch.envs.types import tree_leaves, tree_map
from usv_tpu_torch.tools import (bench_all, bench_asmc_simple, bench_policy, bench_step_anatomy,
                                 bench_train, reference_protocol_bench, scaling_check)
from usv_tpu_torch.vector import BatchedEnv

REPO = Path(__file__).resolve().parents[1]
NEW_MODULES = ["usv_tpu_torch.tools.bench_all", "usv_tpu_torch.tools.bench_step_anatomy",
               "usv_tpu_torch.tools.bench_asmc_simple", "usv_tpu_torch.tools.bench_policy",
               "usv_tpu_torch.tools.bench_train", "usv_tpu_torch.tools.scaling_check",
               "usv_tpu_torch.tools.reference_protocol_bench",
               "usv_tpu_torch.examples.eval_aitsmc", "usv_tpu_torch.examples.population_sweep",
               "usv_tpu_torch.examples.reward_explore"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_script(name):
    """The repo-root JAX script ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def json_lines(text):
    """The JSON objects printed one a line (a Python dict's repr is not one)."""
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return [x for x in out if isinstance(x, dict)]


def run_jax(monkeypatch, capsys, name, argv, mod=None):
    """Run the JAX script's ``main`` with ``argv``; returns its JSON lines."""
    mod = mod or jax_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    mod.main()
    return json_lines(capsys.readouterr().out)


def fake_throughput(handle, num_envs, n_steps=10_000, repeats=3, **_):
    return {"env_steps": num_envs * n_steps, "seconds": 1.0,
            "steps_per_second": float(num_envs * n_steps)}


class FakeJit:
    """``jax.jit`` that compiles nothing: a call returns zeros, ``lower``
    an object whose cost analysis is empty."""

    def __init__(self, fn=None, **_):
        self.fn = fn

    def __call__(self, *args, **kwargs):
        return jnp.zeros((3,))

    def lower(self, *args, **kwargs):
        return self

    def compile(self):
        return self

    def cost_analysis(self):
        return {}


class ScalarJit(FakeJit):
    def __call__(self, *args, **kwargs):
        return jnp.zeros(())


@pytest.mark.parametrize("tool, argv", [
    (bench_all, []), (bench_step_anatomy, []), (bench_asmc_simple, []), (bench_policy, []),
    (bench_train, []), (scaling_check, []), (reference_protocol_bench, ["--side", "core"]),
])
def test_tools_run_on_the_card_unless_told(tool, argv, monkeypatch):
    """No CPU fallback: without CUDA a tool raises unless --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # on a card machine too
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(argv)


def test_bench_all_against_jax(monkeypatch, capsys, tmp_path):
    import usv_tpu.vector

    monkeypatch.setattr(usv_tpu.vector, "throughput", fake_throughput)
    jax_lines = run_jax(monkeypatch, capsys, "bench_all",
                        ["--envs", "4", "--steps", "2", "--out", str(tmp_path / "jax.json")])
    jax_art = json.loads((tmp_path / "jax.json").read_text())

    monkeypatch.setattr(bench_all, "ARTIFACTS", tmp_path / "docs" / "artifacts")  # --round's
    summary = bench_all.main(["--envs", "4", "--steps", "2", "--round", "7", "--device", "cpu"])
    port_lines = json_lines(capsys.readouterr().out)
    art = json.loads((tmp_path / "docs" / "artifacts" / "torch_bench_families_r07.json").read_text())
    assert art == summary
    assert set(art) == set(jax_art) | {"device"} == set(bench_all.ARTIFACT_KEYS)
    assert art["device"] == "cpu"
    assert set(jax_art["families"][0]) == set(bench_all.FAMILY_KEYS)
    assert [f["env"] for f in art["families"]] == [f["env"] for f in jax_art["families"]]
    assert [set(f) for f in art["families"]] == [set(f) for f in jax_art["families"]]
    # the printed lines: one per family, then the summary (with device)
    assert [set(x) for x in port_lines[:-1]] == [set(x) for x in jax_lines[:-1]]
    assert set(port_lines[-1]) == set(jax_lines[-1]) | {"device"} == set(bench_all.SUMMARY_KEYS)
    assert all(f["steps_per_second"] > 0 for f in art["families"])


def test_bench_step_anatomy_rows_against_jax(monkeypatch, capsys):
    monkeypatch.setattr(jax, "jit", FakeJit)
    jax_rows = run_jax(monkeypatch, capsys, "bench_step_anatomy",
                       ["--envs", "2", "--steps", "2", "--repeats", "1", "--cost-analysis"])
    monkeypatch.undo()
    rows = bench_step_anatomy.main(["--envs", "4", "--steps", "2", "--repeats", "1",
                                    "--cost-analysis", "--device", "cpu"])
    assert rows == json_lines(capsys.readouterr().out)
    timed = [r for r in rows if "config" in r]
    jax_timed = [r for r in jax_rows if "config" in r]
    assert [r["config"] for r in timed] == [r["config"] for r in jax_timed]
    assert list(bench_step_anatomy.CONFIGS) == [r["config"] for r in jax_timed]
    assert [set(r) for r in timed] == [set(r) for r in jax_timed]
    assert all(set(r) == set(bench_step_anatomy.ROW_KEYS) for r in jax_timed)
    costs = [r for r in rows if "cost_analysis" in r]
    assert [r["cost_analysis"] for r in costs] == [r["cost_analysis"] for r in jax_rows
                                                    if "cost_analysis" in r]
    assert all(set(r) == set(bench_step_anatomy.COST_KEYS) for r in costs)
    # on the CPU the profiler counts the aten calls; the device figures are null
    assert all(r["aten_calls"] > 0 and r["device_ms"] is None for r in costs)


def tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("env_id", ["usv-simple", "usv-asmc-ca-v0"])
def test_anatomy_rows_step_the_production_state(env_id):
    """``raw`` and ``autoreset`` from one seed equal the env's own step loop
    and ``BatchedEnv``'s auto-reset steps bit for bit (B=8, T=4)."""
    handle = make(env_id, device="cpu")
    anatomy = bench_step_anatomy.Anatomy(handle, 8)
    zeros = torch.zeros((8, handle.cfg.action_dim))

    benv = BatchedEnv(handle, 8)
    state, _ = benv.reset(3)
    raw = state.env
    ended = torch.zeros(8, dtype=torch.bool)
    for _ in range(4):
        state, ts = benv.step(state, zeros)
        raw, _ = handle.step(handle.cfg, raw, zeros)
        ended |= ts.done
    assert tree_equal(anatomy.program("autoreset", 4)(3), state.env)
    assert tree_equal(anatomy.program("raw", 4)(3), raw)
    # select_only draws the reset's block as autoreset does: the two streams
    # stay in step, so the rows whose episode never ended agree
    kept = ~ended
    assert kept.any()
    assert tree_equal(tree_map(lambda x: x[kept], anatomy.program("select_only", 4)(3)),
                      tree_map(lambda x: x[kept], state.env))
    total = anatomy.consume(anatomy.program("bench_exact", 4)(3))
    assert math.isfinite(total)


def old_sensor_sweep(cfg, state):
    """``_sensor_sweep`` before the fix: cast every ray, then overwrite."""
    n = state.obs_xy - state.position[:, None, :2]
    boundary = torch.hypot(n[..., 0], n[..., 1]) - state.obs_r
    dist = torch_simple.sensor_raycast(
        state.position, state.obs_xy, state.obs_r, state.obs_mask, boundary,
        cfg.sensor_count, cfg.sensor_max_range, cfg.sensor_span,
        strict_compat=cfg.strict_compat_raycast, backend=cfg.raycast_backend)
    if cfg.ignore_obstacles:
        return torch.ones_like(dist[:, 0]), torch.full_like(dist, cfg.sensor_max_range)
    return torch.where(state.obs_mask, boundary, math.inf).amin(-1), dist


def run_steps(env_id, steps=20, B=8):
    handle = make(env_id, device="cpu", ignore_obstacles=True, max_episode_steps=7)
    benv = BatchedEnv(handle, B)
    g = torch.Generator().manual_seed(5)
    n = handle.n_uniform(handle.cfg)
    state, obs = benv.reset(0, uniform=torch.rand((B, n), generator=g))
    out = [obs]
    for _ in range(steps):
        a = torch.rand((B, handle.cfg.action_dim), generator=g) * 2 - 1
        state, ts = benv.step(state, a, uniform=torch.rand((B, n), generator=g))
        out += [ts.obs, ts.reward, ts.terminated, ts.truncated,
                *[v for k, v in sorted(ts.info.items())]]
    return out, state


@pytest.mark.parametrize("env_id", ["usv-simple", "usv-asmc-simple", "usv-aitsmc-simple"])
def test_ignore_obstacles_casts_no_ray(env_id, monkeypatch):
    calls = []
    real = torch_simple.sensor_raycast
    monkeypatch.setattr(torch_simple, "sensor_raycast",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    new, new_state = run_steps(env_id)
    assert calls == []
    monkeypatch.setattr(torch_simple, "_sensor_sweep", old_sensor_sweep)
    old, old_state = run_steps(env_id)
    assert len(calls) == 20
    assert len(new) == len(old) and all(torch.equal(a, b) for a, b in zip(new, old))
    assert tree_equal(new_state.env, old_state.env)


def test_bench_asmc_simple_against_jax(monkeypatch, capsys):
    import usv_tpu.vector

    monkeypatch.setattr(usv_tpu.vector, "throughput", fake_throughput)
    jax_rows = run_jax(monkeypatch, capsys, "bench_asmc_simple",
                       ["--envs", "2", "--steps", "2", "--unrolls", "1", "4"])
    rows = bench_asmc_simple.main(["--envs", "2", "--steps", "2", "--unrolls", "1", "4",
                                   "--device", "cpu"])
    assert rows == json_lines(capsys.readouterr().out)
    assert [r["config"] for r in rows] == [r["config"] for r in jax_rows]
    assert [set(r) for r in rows] == [set(r) for r in jax_rows]
    assert all(set(r) == set(bench_asmc_simple.ROW_KEYS) for r in jax_rows)
    assert [r["config"] for r in rows] == [c[0] for c in bench_asmc_simple.configs([1, 4])]


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def test_bench_policy_chain_against_jax(monkeypatch, capsys):
    """The same weights, the same obs: JAX's chained ``last[-1]`` and the
    port's at batch 8, chain 8, within 1e-4; the rows' fields are JAX's."""
    from usv_tpu_torch.convert import state_dict_from_flax
    from usv_tpu_torch.train.policy import Policy, build_module

    mod = jax_script("bench_policy")
    jax_policy = mod._fresh_policy()
    seen = []
    real_jit = jax.jit

    def recording_jit(fn, **kw):
        jitted = real_jit(fn, **kw)
        if getattr(fn, "__name__", "") != "chained":
            return jitted
        return lambda *a: seen.append(float(jitted(*a))) or jitted(*a)

    monkeypatch.setattr(jax, "jit", recording_jit)
    jax_rows = mod.bench_policy(jax_policy, (8,), chain=8, latency_calls=2)
    monkeypatch.undo()

    module = build_module(jax_policy.meta)
    module.load_state_dict(state_dict_from_flax(flatten(jax_policy.params)), strict=True)
    policy = Policy(jax_policy.meta, module, "cpu")
    obs0 = torch.as_tensor(np.random.default_rng(0).standard_normal((8, policy.obs_dim)),
                           dtype=torch.float32)
    got = float(bench_policy.chain_last(policy, obs0, 8))
    assert abs(got - seen[0]) <= 1e-4, (got, seen[0])

    rows = bench_policy.bench_policy(policy, (8,), chain=8, latency_calls=2)
    assert [set(r) for r in rows] == [set(r) for r in jax_rows] == [set(bench_policy.ROW_KEYS)]
    out = bench_policy.main(["--batch", "1", "8", "--chain", "4", "--latency-calls", "3",
                             "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "obs_dim=715" in printed and "device=cpu" in printed
    assert out == json_lines(printed) and [r["batch"] for r in out] == [1, 8]
    assert bench_policy._fresh_policy(device="cpu").meta == jax_policy.meta


def fake_sac_learner(real_cls, log):
    """A JAX ``SacLearner`` whose rounds count the updates the real one
    would make (its own fusion) and train nothing."""
    TS = namedtuple("TS", "log_alpha grad_steps")

    class Fake:
        def __init__(self, handle, cfg):
            self.real = real_cls(handle, cfg)
            self.cfg = cfg

        def init(self, seed=0):
            return TS(jnp.zeros(()), 0)

        def train_rounds(self, ts, n):
            per_round = self.cfg.gradient_steps // self.real._fusion
            log.append(per_round)
            return ts._replace(grad_steps=ts.grad_steps + n * per_round), None

    return Fake


def fake_ppo_learner():
    TS = namedtuple("TS", "update_count")

    class Fake:
        def __init__(self, handle, cfg):
            self.cfg = cfg

        def init(self, seed=0):
            return TS(jnp.zeros(()))

        def _collect(self, ts, key):
            return ts, {"obs": jnp.zeros((2,)), "done": jnp.zeros((2,))}, jnp.zeros(())

        def train_iteration(self, ts):
            return TS(ts.update_count + 1), None

    return Fake


SAC_FLAGS = ["--envs", "4", "--rounds", "2", "--train-freq", "2", "--gradient-steps", "8",
             "--batch-size", "8", "--buffer-size", "64"]


def test_bench_train_against_jax(monkeypatch, capsys):
    import usv_tpu.train.ppo
    import usv_tpu.train.sac

    from usv_tpu_torch.train import ppo as torch_ppo

    log = []
    monkeypatch.setattr(usv_tpu.train.sac, "SacLearner",
                        fake_sac_learner(usv_tpu.train.sac.SacLearner, log))
    monkeypatch.setattr(usv_tpu.train.ppo, "PpoLearner", fake_ppo_learner())
    mod = jax_script("bench_train")
    jax_sac = run_jax(monkeypatch, capsys, "bench_train", SAC_FLAGS, mod)
    ppo_flags = ["--algo", "ppo", "--envs", "4", "--ppo-batch-sizes", "16", "32",
                 "--ppo-fusions", "1", "2", "--sweep-shuffle"]
    jax_ppo = run_jax(monkeypatch, capsys, "bench_train", ppo_flags, mod)
    monkeypatch.setattr(sys, "argv", ["pytest"])

    sac = bench_train.main(SAC_FLAGS + ["--device", "cpu"])
    assert [r["mode"] for r in sac] == [r["mode"] for r in jax_sac] == list(bench_train.MODES)
    assert [set(r) for r in sac] == [set(r) for r in jax_sac]
    assert set(jax_sac[0]) == set(bench_train.SAC_KEYS)
    # the SAC cycle: updates a round by mode, and the grad_steps after the
    # warm-up and the timed rounds
    assert [r["grad_steps"] for r in sac] == [r["grad_steps"] for r in jax_sac]
    assert [r["grad_steps"] for r in sac] == [2 * 2 * per for per in log[::2]]

    # PPO's rollout depth cut to 8 steps: the JAX rows carry the default 2048
    # in optimizer_steps_per_iter, so they are held to the formula below
    real_cfg = torch_ppo.PpoConfig
    monkeypatch.setattr(torch_ppo, "PpoConfig",
                        lambda **kw: real_cfg(**{"n_steps": 8, **kw}))
    ppo = bench_train.main(ppo_flags + ["--device", "cpu"])
    assert [set(r) for r in ppo] == [set(r) for r in jax_ppo]
    assert set(jax_ppo[0]) == set(bench_train.PPO_KEYS)
    key = ["batch_size", "update_fusion", "reshuffle_epochs"]
    assert [[r[k] for k in key] for r in ppo] == [[r[k] for k in key] for r in jax_ppo]
    for p, j in zip(ppo, jax_ppo):
        steps = 2048 * 4
        assert j["optimizer_steps_per_iter"] == 10 * (steps // (p["batch_size"] * p["update_fusion"]))
        assert p["optimizer_steps_per_iter"] == 10 * (8 * 4 // (p["batch_size"] * p["update_fusion"]))
        assert p["iter_ms"] > 0 and p["rollout_ms"] > 0


PREDICT_FLAGS = [
    ["--predict-only"],
    ["--predict-only", "--ici-gbps", "45", "--predict-bf16-grads"],
    ["--predict-only", "--predict-sac-steps-per-s", "1.5e6", "--predict-ppo-steps-per-s", "7e5"],
]


@pytest.mark.parametrize("flags", PREDICT_FLAGS)
def test_scaling_predict_equals_jax(flags, monkeypatch, capsys):
    mod = jax_script("scaling_check")
    monkeypatch.setattr(sys, "argv", ["scaling_check.py", *flags])
    capsys.readouterr()
    mod.main()
    jax_out = json.loads(capsys.readouterr().out)
    out = scaling_check.main(flags)
    assert json.loads(capsys.readouterr().out) == jax_out
    assert out == jax_out  # the rows and the model text, exactly


def test_scaling_check_measures_ranks(monkeypatch, capsys):
    """Two gloo ranks on the CPU: the rows have JAX's keys, with its note."""
    monkeypatch.setattr(jax, "jit", ScalarJit)
    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:2])  # sizes 1 and 2
    jax_lines = run_jax(monkeypatch, capsys, "scaling_check", ["--envs-per-device", "2",
                                                               "--steps", "2"])
    monkeypatch.undo()
    out = scaling_check.main(["--force-cpu-devices", "2", "--envs-per-device", "2",
                              "--steps", "3"])
    lines = json_lines(capsys.readouterr().out)
    assert lines[0] == jax_lines[0] == {"note": scaling_check.CPU_NOTE}
    jax_rows = [x for x in jax_lines if "devices" in x]
    assert [r["devices"] for r in out["scaling"]] == [1, 2]
    assert [set(r) for r in out["scaling"]] == [set(r) for r in jax_rows[:2]]
    assert set(jax_rows[0]) == set(scaling_check.ROW_KEYS)
    assert set(out) == set(jax_lines[-1]) | {"device"} and out["device"] == "cpu"
    assert [r["num_envs"] for r in out["scaling"]] == [2, 4]


def test_reference_protocol_bench_against_jax(monkeypatch, capsys, tmp_path):
    import usv_tpu.vector

    import usv_tpu_torch.vector

    mod = jax_script("reference_protocol_bench")
    monkeypatch.setattr(mod, "ARTIFACT", tmp_path / "jax.json")
    monkeypatch.setattr(mod, "_loop_steps_per_s", lambda fn, n, sync=None, warmup=100: (1.0, 1.0))
    monkeypatch.setattr(usv_tpu.vector, "throughput", fake_throughput)
    for side in ("compat", "core", "crossover"):
        run_jax(monkeypatch, capsys, "reference_protocol_bench",
                ["--side", side, "--platform", "cpu", "--steps", "4", "--batches", "1", "2"], mod)
    jax_art = json.loads((tmp_path / "jax.json").read_text())

    monkeypatch.setattr(reference_protocol_bench, "ARTIFACT", tmp_path / "port.json")
    monkeypatch.setattr(usv_tpu_torch.vector, "throughput", fake_throughput)  # the crossover's scan column
    common = ["--device", "cpu", "--steps", "4", "--warmup", "2", "--batches", "1", "2"]
    for side in ("compat", "core", "crossover"):
        reference_protocol_bench.main(["--side", side] + common)
    art = json.loads((tmp_path / "port.json").read_text())
    assert sorted(art) == sorted(jax_art) == ["compat_cpu_loop", "core_scan_cpu_b1", "crossover_cpu"]
    for name, rec in art.items():
        assert set(rec) == set(jax_art[name]) | {"device"} and rec["device"] == "cpu"
    assert [set(r) for r in art["crossover_cpu"]["rows"]] == \
        [set(r) for r in jax_art["crossover_cpu"]["rows"]]
    assert set(jax_art["crossover_cpu"]["rows"][0]) == set(reference_protocol_bench.CROSSOVER_ROW_KEYS)
    assert set(art["crossover_cpu"]) == set(reference_protocol_bench.CROSSOVER_KEYS)
    assert set(art["core_scan_cpu_b1"]) == set(art["compat_cpu_loop"]) == \
        set(reference_protocol_bench.LOOP_KEYS)
    assert art["compat_cpu_loop"]["steps_per_second"] > 0
    assert reference_protocol_bench.ARTIFACT.name == "port.json"
    default = Path(reference_protocol_bench.__file__).resolve().parents[2] / "docs" / "artifacts"
    assert (default / "torch_single_env_protocol_h100.json") != mod.REPO / "docs" / "artifacts" / \
        "single_env_protocol_r5.json"


_IMPORTS = r"""
import importlib, json, sys
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
print(json.dumps(sorted(m for m, v in sys.modules.items()
                        if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax", "usv_tpu"))))
"""


def test_new_modules_load_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORTS, json.dumps(NEW_MODULES)], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout) == []

"""Each traffic driver against its reference at a tiny size on the CPU,
through the harness's functions (the command itself refuses without a card):
sound runs pass, the bfloat16 control and planted faults do not, the result
line has the contract's keys, nothing of JAX or the JAX package is loaded,
and a cell or metric is added by new files and entries alone."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["simple-sim-4096", "ca-sim-4096", "simple-gym-1"]
SAC = "simple-sac-1024"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# a learner small enough for the CPU: 16 envs, rounds of 8 collect steps (4 of
# them the warm-up's) and 4 updates of batch 32, the nets' widths cut
TINY_LEARNER = dict(num_envs=16, train_freq=8, gradient_steps=16, update_fusion=4, batch_size=8,
                    buffer_size=256, learning_starts=64, hidden=[64, 48])


def tiny(name):
    """A cell's configuration, traffic (16 envs where it has a batch, the
    tiny learner where it trains) and driver."""
    manifest = harness.load_manifest(ROOT)
    cell = harness.cell_of(manifest, name)
    config, traffic = harness.config_of(manifest, cell, ROOT), dict(harness.traffic_of(cell))
    if "num_envs" in traffic:
        traffic["num_envs"] = 16
    if traffic["driver"] == "sac_train":
        config["learner"] = dict(config["learner"], **TINY_LEARNER)
    return config, traffic, harness.driver_of(traffic)


def run(name, seed=2**31 + 17, seconds=0.3, system=None, device="cpu"):
    config, traffic, driver = tiny(name)
    kw = {} if system is None else {"system": system}
    cell = driver.Cell(config, traffic, seed, device, **kw)
    window = cell.window(seconds)
    cell.release()
    return window, harness.judge(cell.check(), config["limits"][driver.LIMITS])


@pytest.mark.parametrize("name", CELLS + [SAC])
def test_program_matches_reference(name):
    window, checks = run(name)
    assert window["attempted"] > 0
    assert all(c["ok"] for c in checks), checks


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails(name):
    _, traffic, _ = tiny(name)
    _, checks = run(name, seed=5, system=control.control_system(traffic["driver"]))
    assert not all(c["ok"] for c in checks), checks


# ------------------------------------------------------------------ faults

class FaultyBatch:
    """The program's ``BatchedEnv`` with one fault planted in its step."""

    def __init__(self, fault):
        self.fault = fault

    def __call__(self, config, num_envs, device):
        from benchmark.drivers import rollout

        self.env = rollout.program(config, num_envs, device)
        return self

    def reset(self, generator):
        return self.env.reset(generator)

    def step(self, state, actions):
        from usv_tpu_torch.envs.types import tree_map

        new, ts = self.env.step(state, actions)
        if self.fault == "frozen":            # the state returned unchanged
            return state, ts
        if self.fault == "half":              # half of the batch left out
            half = torch.arange(actions.shape[0]) < actions.shape[0] // 2

            def keep(n, o):
                return torch.where(half.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

            zero = torch.zeros_like
            ts = dataclasses.replace(ts, obs=keep(ts.obs, zero(ts.obs)),
                                     reward=keep(ts.reward, zero(ts.reward)))
            return dataclasses.replace(new, env=tree_map(keep, new.env, state.env)), ts
        if self.fault == "altered":           # one answer altered where it is produced
            obs = ts.obs.clone()
            obs[0, 0] += 0.01
            return new, dataclasses.replace(ts, obs=obs)
        raise KeyError(self.fault)


class FaultyGym:
    """The program's gym adapter with one fault planted in ``step`` (one env:
    there is no half of a batch to leave out)."""

    def __init__(self, fault):
        self.fault = fault

    def __call__(self, config, device):
        from benchmark.drivers import gym_loop

        self.env = gym_loop.program(config, device)
        return self

    @property
    def _state(self):
        return self.env._state

    def reset(self, seed):
        return self.env.reset(seed=seed)

    def step(self, action):
        before = self.env._state
        obs, reward, terminated, truncated, info = self.env.step(action)
        if self.fault == "frozen":
            self.env._state = before
        elif self.fault == "altered":
            obs = obs.copy()
            obs[0] += 0.01
        return obs, reward, terminated, truncated, info


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS[:2] for f in ("frozen", "half", "altered")]
                         + [("simple-gym-1", "frozen"), ("simple-gym-1", "altered")]
                         + [(SAC, f) for f in ("frozen", "half_batch", "altered")])
def test_faults_make_correct_false(name, fault):
    if name == SAC:
        system = control.faulty_learner(fault)
    else:
        system = FaultyGym(fault) if name == "simple-gym-1" else FaultyBatch(fault)
    _, checks = run(name, system=system)
    assert not all(c["ok"] for c in checks), (fault, checks)


@pytest.mark.gpu
def test_tf32_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    _, checks = run(SAC, seed=5, system=control.control_system("sac_train"), device="cuda")
    assert not all(c["ok"] for c in checks), checks
    _, checks = run(SAC, seed=5, device="cuda")
    assert all(c["ok"] for c in checks), checks


# ------------------------------------------------------------ result line

def test_result_line_keys(monkeypatch):
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 1 << 20)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "rehearsal")
    real = harness.traffic_of
    monkeypatch.setattr(harness, "traffic_of",
                        lambda cell: dict(real(cell), **({"num_envs": 16} if "num_envs" in real(cell) else {})))
    from benchmark.drivers import rollout

    def fake_profile(self):
        return harness.Slice(steps=2, window_s=0.01, busy_s=0.001, aten_calls=1600,
                             kernel_s={"raycast_kernel": [1e-5, 1e-5]},
                             idle_gaps=[["aten::add", 0.002]], extra={"raycast": {"seconds": 1e-6}})

    monkeypatch.setattr(rollout.Cell, "profile", fake_profile)
    manifest = harness.load_manifest(ROOT)
    cell = harness.cell_of(manifest, "simple-sim-4096")
    for trace in (False, True):
        line, checks = harness.run_cell(manifest, cell, 9, 0.2, trace, time.perf_counter(), "cpu")
        keys = {"correct", "attempted", "failed", "metrics", "device"} | ({"breakdown"} if trace else set())
        assert set(line) == keys and line["correct"] is True
        want = {m["name"] for m in harness.metrics_of(manifest, cell, trace)}
        assert set(line["metrics"]) == want
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        if trace:
            assert set(line["device"]) >= {"busy_s", "window_s"}
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert [c["name"] for c in checks] == list(harness.Comparison.NAMES)


# --------------------------------------------------------------- purity

def _python(code, cwd=ROOT, env_path=None):
    env = dict(os.environ, PYTHONPATH=env_path or str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_jax_after_a_run_and_a_reference_of_its_own():
    out = _python(
        "import torch, sys; torch.set_num_threads(2)\n"
        "from benchmark.tests.test_bench_cells import run\n"
        "run('ca-sim-4096'); run('simple-gym-1'); run('simple-sac-1024')\n"
        "from benchmark import harness\n"
        "print(harness.foreign_modules(), 'usv_tpu_torch' in sys.modules)\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] True"
    out = _python(
        "import sys, importlib, pkgutil, benchmark.reference as r\n"
        "[importlib.import_module('benchmark.reference.' + m.name) for m in pkgutil.iter_modules(r.__path__)]\n"
        "import benchmark.roofline\n"
        "print(sorted({n.split('.')[0] for n in sys.modules} & {'usv_tpu', 'usv_tpu_torch', 'jax', 'flax'}))\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------- the CLI

def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command runs the cell (test_cli_on_the_card)")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "simple-gym-1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == "" and "CUDA" in out.stderr


def test_cli_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "simple-sim-4096",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=""), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
def test_cli_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "simple-gym-1",
                          "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"gym_step_p95_ms", "setup_s"}


@pytest.mark.gpu
def test_traced_cli_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", SAC,
                          "--seed", "2147483998", "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    manifest = harness.load_manifest(ROOT)
    want = {m["name"] for m in harness.metrics_of(manifest, harness.cell_of(manifest, SAC), True)}
    assert line["correct"] is True and set(line["metrics"]) == want
    assert all(0 < v["value"] <= 100 for k, v in line["metrics"].items() if v["unit"] == "%")
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
    # no record_function range (the optimizer's own) counted as a device operation
    assert not any(name.startswith("Optimizer.") for name, _ in line["breakdown"]["device_ops"])


# ------------------------------------------------------- data-driven cells

def test_a_cell_and_a_metric_added_by_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    (bench / "traffic" / "rollout-16.json").write_text(json.dumps(
        {"driver": "rollout", "num_envs": 16, "warmup_steps": 2,
         "checked_steps": 4, "slice_steps": 2}))
    (bench / "metrics" / "sim_steps_in_window.py").write_text(
        "def read(record):\n    return record.window['steps']\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "ca-sim-16", "config": "usv-asmc-ca-v0",
                                  "traffic": "rollout-16", "chips": 1, "why": "a test cell"})
    manifest["per_layer"].append({"name": "sim_steps_in_window", "unit": "steps", "better": "higher",
                                  "source": "host_clock", "layer": "env step",
                                  "moves": "sim_env_steps_per_s", "workloads": ["ca-sim-16"]})
    manifest["end_to_end"][0]["workloads"].append("ca-sim-16")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = _python(
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        "m = harness.load_manifest(harness.ROOT); cell = harness.cell_of(m, 'ca-sim-16')\n"
        "config, traffic = harness.config_of(m, cell, harness.ROOT), harness.traffic_of(cell)\n"
        "run = harness.driver_of(traffic).Cell(config, traffic, 3, 'cpu')\n"
        "w = run.window(0.3); run.release()\n"
        "ok = all(c['ok'] for c in harness.judge(run.check(), config['limits']['env']))\n"
        "rec = harness.Record(cell, config, traffic, 1.0, w)\n"
        "print(ok, [(x['name'], harness.reader_of(x['name'])(rec) > 0)\n"
        "           for x in harness.metrics_of(m, cell, False) + harness.metrics_of(m, cell, True)\n"
        "           if x['name'] != 'setup_s' and x['source'] == 'host_clock'])\n",
        cwd=tmp_path, env_path=f"{tmp_path}{os.pathsep}{ROOT}")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        "True [('sim_env_steps_per_s', True), ('sim_steps_in_window', True)]"

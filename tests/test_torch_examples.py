"""The port's examples (``usv_tpu_torch/examples/``) against the JAX
package's repo-root ``examples/``, on the CPU at tiny sizes.

* ``reward_explore``: the curves, read from the port's ``compute_reward``,
  equal the ones the JAX script plots on the same grid within 1e-6, and go
  to JSON beside the figure;
* ``eval_aitsmc``: the JAX script's wiring (the env's episode length, the
  notebook's gain overrides, the perturbation impulse, the scripted
  setpoint, the rollout's length and frame stack) is the port's, read with
  JAX's rollout stubbed; the port's run writes its trace and summary as
  JSON, with a trained SAC checkpoint as the policy too;
* ``population_sweep``: with JAX's learner stubbed, the JAX script and the
  port's real run at the same flags print the same block lines; the port
  writes the sweep's JSON and exports the best seed's bundle.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usv_tpu_torch.examples import eval_aitsmc, population_sweep, reward_explore

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reward_explore_curves_equal_jax(monkeypatch, tmp_path, capsys):
    import matplotlib.figure

    plotted = []
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda fig, *a, **k: plotted.extend(ax.lines[0].get_xydata()
                                                            for ax in fig.axes))
    monkeypatch.setattr(sys, "argv", ["reward_explore.py", "--out", str(tmp_path / "jax.png")])
    jax_example("reward_explore").main()
    assert len(plotted) == 4
    monkeypatch.undo()

    curves = reward_explore.main(["--out", str(tmp_path / "port.png"), "--device", "cpu"])
    assert json.loads((tmp_path / "port.json").read_text()) == curves
    assert (tmp_path / "port.png").exists()
    assert list(curves) == ["ye_reward", "angle_to_target_reward", "velocity_track_reward",
                            "delta_action_reward"]
    for c, xy in zip(curves.values(), plotted):
        np.testing.assert_array_equal(c["x"], xy[:, 0])
        np.testing.assert_allclose(c["y"], xy[:, 1], rtol=0, atol=1e-6)


def gains_dict(g):
    return {k: float(v) for k, v in vars(g).items()} if hasattr(g, "__dict__") else \
        {k: float(getattr(g, k)) for k in g._fields}


def test_eval_aitsmc_wiring_equals_jax(monkeypatch, tmp_path, capsys):
    import usv_tpu.train.evaluate as jax_evaluate

    seen = {}

    def fake_rollout(handle, policy, n_steps, frame_stack=0, **kw):
        seen.update(handle=handle, policy=policy, n_steps=n_steps, frame_stack=frame_stack)
        return {"reward": np.zeros(n_steps), "Ka_u": np.zeros(n_steps), "Ka_r": np.zeros(n_steps)}

    monkeypatch.setattr(jax_evaluate, "rollout_with_info", fake_rollout)
    monkeypatch.setattr(jax_evaluate, "plot_diagnostics", lambda trace, out_path=None: out_path)
    monkeypatch.setattr(sys, "argv", ["eval_aitsmc.py", "--out", str(tmp_path / "jax"),
                                      "--steps", "6", "--perturb", "--k-r", "0.6"])
    jax_example("eval_aitsmc").main()
    monkeypatch.undo()

    summary = eval_aitsmc.main(["--out", str(tmp_path / "port"), "--steps", "6", "--perturb",
                                "--k-r", "0.6", "--device", "cpu"])
    data = json.loads((tmp_path / "port" / "diagnostics.json").read_text())
    assert data["summary"] == summary
    assert set(summary) >= {"mean_reward_per_step", "final_Ka_u", "final_Ka_r"}
    trace = data["trace"]
    assert all(len(v) == 6 for v in trace.values())
    assert {"reward", "Ka_u", "Ka_r", "position", "perturb", "setpoint_u"} <= set(trace)
    assert (tmp_path / "port" / "diagnostics.png").exists()

    jax_handle = seen["handle"]
    assert seen["n_steps"] == 6 and seen["frame_stack"] == 1
    assert jax_handle.cfg.max_episode_steps == 4000
    # the notebook's gain overrides, bound into the handle's step
    jax_gains = jax_handle.step.__defaults__[0]
    from usv_tpu_torch.control.aitsmc import AitsmcGains

    port_gains = AitsmcGains(k_r=0.6, kmin_r=0.001, mu_r=0.025, mu_u=0.01)
    assert gains_dict(jax_gains) == gains_dict(port_gains)
    # the impulse over steps 0..199, and the scripted setpoint
    steps = np.arange(200, dtype=np.int32)
    want = np.asarray(jax.vmap(jax_handle.cfg.perturb_fn)(jnp.asarray(steps)))  # one env's step
    got = eval_aitsmc.perturb_func(torch.as_tensor(steps)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(seen["policy"](None)), [0.5, 0.0])


def test_eval_aitsmc_from_a_checkpoint(monkeypatch, tmp_path, capsys):
    """``--ckpt``: a SAC checkpoint's actor drives the rollout (the template's
    replay shrunk to the saved one's)."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train import sac
    from usv_tpu_torch.train.checkpoint import save_checkpoint

    real = sac.SacConfig
    monkeypatch.setattr(sac, "SacConfig", lambda **kw: real(**{"buffer_size": 64, **kw}))
    learner = sac.SacLearner(make("usv-aitsmc-simple", device="cpu"), sac.SacConfig(num_envs=1))
    save_checkpoint(tmp_path / "ckpt", learner.init(seed=3), 40)
    summary = eval_aitsmc.main(["--out", str(tmp_path / "out"), "--steps", "4", "--ckpt",
                                str(tmp_path / "ckpt"), "--device", "cpu"])
    assert "loaded checkpoint at step 40" in capsys.readouterr().out
    trace = json.loads((tmp_path / "out" / "diagnostics.json").read_text())["trace"]
    assert len(trace["obs"][0]) == 143 and np.isfinite(summary["mean_reward_per_step"])


BLOCK = re.compile(r"steps/seed +([\d,]+)  aggregate +[\d.]+M steps/s  eval per seed \[.*\]  "
                   r"mean -?[\d.]+ \+/- [\d.]+")
BEST = re.compile(r"best per seed \[.*\]  best overall -?[\d.]+ \(seed \d+\)")
FLAGS = ["--seeds", "2", "--total-steps", "16", "--num-envs", "2", "--buffer-size", "64",
         "--learning-starts", "16", "--rounds-per-block", "1"]


def fake_population_learner():
    """A JAX SAC learner that trains nothing and scores seed i at 0.1 i."""
    class Fake:
        def __init__(self, handle, cfg):
            self.cfg = cfg

        def init_many(self, seeds):
            self.n = len(seeds)
            return type("TS", (), {"actor_params": {"w": jnp.zeros((self.n, 2))}})()

        def train_rounds_many(self, ts, rounds):
            return ts, None

        def eval_policy_many(self, ts, n_steps, num_envs):
            return jnp.arange(self.n) * 0.1

    return Fake


def test_population_sweep_against_jax(monkeypatch, tmp_path, capsys):
    import usv_tpu.train.sac

    monkeypatch.setattr(usv_tpu.train.sac, "SacLearner", fake_population_learner())
    monkeypatch.setattr(sys, "argv", ["population_sweep.py", *FLAGS])
    capsys.readouterr()
    jax_example("population_sweep").main()
    jax_out = capsys.readouterr().out.splitlines()
    monkeypatch.undo()

    out = population_sweep.main(FLAGS + ["--out", str(tmp_path / "sweep.json"), "--export-best",
                                         str(tmp_path / "best"), "--device", "cpu"])
    lines = [x for x in capsys.readouterr().out.splitlines() if BLOCK.match(x) or BEST.match(x)]
    jax_lines = [x for x in jax_out if BLOCK.match(x) or BEST.match(x)]
    assert len(lines) == len(jax_lines) == 2  # one block of 16 env-steps a seed, then the best
    assert [BLOCK.match(x).group(1) for x in lines[:-1]] == \
        [BLOCK.match(x).group(1) for x in jax_lines[:-1]]
    assert json.loads((tmp_path / "sweep.json").read_text()) == out
    assert [b["steps_per_seed"] for b in out["blocks"]] == [16]
    assert all(len(b["evals"]) == 2 for b in out["blocks"]) and out["device"] == "cpu"
    assert out["best_seed"] == int(np.argmax(out["best_per_seed"]))
    assert (tmp_path / "best" / "policy.json").exists() and out["exported"]

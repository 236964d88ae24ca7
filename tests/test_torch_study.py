"""The port's band study (``usv_tpu_torch/tools/study_robust_band.py``)
against the JAX package's (``tools/study_robust_band.py``), on the CPU.

One tiny study (2 invocations of a 2-seed SAC population, 256 env-steps a
seed) runs in a subprocess that also lists the modules it loaded. Then:

* the artifact's key tree (the port's ``device`` and ``untrained_floor``
  set aside) equals that of the committed JAX record,
  ``docs/artifacts/sac_robust_budget_100m_r5.json``;
* ``command`` and ``protocol`` are the strings the JAX study writes for the
  same flags (run with its trainer and its ``bundle_eval`` stubbed);
* ``mean``, ``std`` and ``floor`` follow from the invocations, and each
  winner is the candidate with the highest selection mean;
* ``untrained_floor`` scores, per invocation, the robust recipe's fresh
  actor of the base seed: the weights ``SacLearner.init(base)`` makes (and,
  for ``--learner ppo``, the model ``PpoLearner.init(base)`` makes);
* the run loaded no ``jax`` and no ``usv_tpu`` module.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from usv_tpu_torch.train import run_sac

REPO = Path(__file__).resolve().parents[1]
JAX_RECORD = REPO / "docs" / "artifacts" / "sac_robust_budget_100m_r5.json"
PORT_KEYS = {"device", "untrained_floor"}
TRAIN_ARGS = [
    "--population", "2", "--num-envs", "8", "--train-freq", "8", "--gradient-steps", "2",
    "--update-fusion", "1", "--buffer-size", "1024", "--learning-starts", "64",
    "--batch-size", "32", "--rounds-per-block", "2", "--eval-every-blocks", "2",
    "--eval-envs", "4", "--select-evals", "2", "--checkpoint-every-blocks", "0",
]
BASE = 9500


def study_flags(outdir, artifact):
    return [
        "--learner", "sac", "--env", "usv-simple", "--invocations", "2",
        "--total-steps", "256", "--base-seed-start", str(BASE), "--best-metric", "reward",
        "--eval-steps", "8", "--eval-episodes", "4", "--eval-seeds", "2",
        "--outdir", str(outdir), "--artifact", str(artifact),
    ] + [f"--train-arg={a}" for a in TRAIN_ARGS]


_RUN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from usv_tpu_torch.tools import study_robust_band
study_robust_band.main(json.loads(sys.argv[1]))
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax", "usv_tpu"))
print("LOADED " + json.dumps(loaded))
"""


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("study")
    argv = study_flags(tmp / "runs", tmp / "artifact.json") + ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _RUN, json.dumps(argv)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    loaded = json.loads(out.stdout.split("LOADED ")[-1])
    return dict(artifact=json.loads((tmp / "artifact.json").read_text()), loaded=loaded,
                outdir=tmp / "runs")


def key_tree(x):
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [key_tree(x[0])] if x else []
    return None


def test_artifact_has_the_jax_records_key_tree(study):
    art = study["artifact"]
    assert PORT_KEYS <= set(art)
    ours = key_tree({k: v for k, v in art.items() if k not in PORT_KEYS})
    assert ours == key_tree(json.loads(JAX_RECORD.read_text()))
    assert art["device"] == "cpu"


def test_command_and_protocol_match_the_jax_study(study, tmp_path, monkeypatch):
    pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")
    from usv_tpu.train import evaluate as jevaluate
    from usv_tpu.train import run_sac as jrun_sac

    def fake_main(argv):
        logdir = Path(argv[argv.index("--logdir") + 1])
        base = int(argv[argv.index("--seed") + 1])
        (logdir / "policy_best").mkdir(parents=True)
        selection = [dict(seed=base, select_mean=0.5)]
        (logdir / "policy_best" / "policy.json").write_text(json.dumps(
            {"population": dict(winner_seed=base, selection=selection)}))

    monkeypatch.setattr(jrun_sac, "main", fake_main)
    monkeypatch.setattr(jevaluate, "bundle_eval", lambda *a, seed=0, **k: {"reward_per_step": 0.1 * seed})
    spec = importlib.util.spec_from_file_location("jax_study_robust_band",
                                                  REPO / "tools" / "study_robust_band.py")
    jstudy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jstudy)
    monkeypatch.setattr(sys, "argv", ["study_robust_band.py"]
                        + study_flags(tmp_path / "runs", tmp_path / "jax.json"))
    jstudy.main()
    jax_art = json.loads((tmp_path / "jax.json").read_text())
    for key in ("command", "protocol", "env", "learner", "total_steps_per_seed", "score_key"):
        assert study["artifact"][key] == jax_art[key], key
    assert [r["base_seed"] for r in study["artifact"]["invocations"]] == \
        [r["base_seed"] for r in jax_art["invocations"]] == [BASE, BASE + 100]


def test_band_statistics_follow_from_the_invocations(study):
    art = study["artifact"]
    means = [r["reward_per_step_mean"] for r in art["invocations"]]
    assert art["mean"] == round(float(np.mean(means)), 4)
    assert art["std"] == round(float(np.std(means, ddof=1)), 4)
    assert art["floor"] == min(means)
    assert art["max_wall_seconds"] == max(r["wall_seconds"] for r in art["invocations"])
    for rec in art["invocations"]:
        assert len(rec["evals"]) == 2
        assert abs(rec["reward_per_step_mean"] - np.mean([e["reward_per_step"] for e in rec["evals"]])) <= 1e-4
        best = max(rec["selection"], key=lambda s: s["select_mean"])
        assert rec["winner_seed"] == best["seed"]
        assert [s["seed"] for s in rec["selection"]] == [rec["base_seed"], rec["base_seed"] + 1]


def test_untrained_floor_scores_the_fresh_actor_of_the_base_seed(study):
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.sac import SacLearner

    floors = study["artifact"]["untrained_floor"]
    assert [f["base_seed"] for f in floors] == [BASE, BASE + 100]
    for f in floors:
        assert len(f["evals"]) == 2
        assert abs(f["reward_per_step_mean"] - np.mean([e["reward_per_step"] for e in f["evals"]])) <= 1e-4
    argv = ["--recipe", "robust", "--seed", str(BASE)] + TRAIN_ARGS
    args = run_sac.apply_recipe(run_sac.build_parser().parse_args(argv))
    learner = SacLearner(make("usv-simple", device="cpu"), run_sac.sac_config(args))
    fresh = learner.init(seed=BASE).actor.state_dict()
    saved = torch.load(study["outdir"] / f"sac_usv-simple_b{BASE}" / "policy_init" / "params.pt")
    assert saved.keys() == fresh.keys()
    for k in fresh:
        assert torch.equal(saved[k], fresh[k]), k


@pytest.mark.parametrize("learner", ["sac", "ppo"])
def test_fresh_policy_is_the_init_of_the_base_seed(learner, tmp_path):
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.tools.study_robust_band import export_fresh_policy
    from usv_tpu_torch.train import run_ppo
    from usv_tpu_torch.train.ppo import PpoLearner
    from usv_tpu_torch.train.sac import SacLearner

    argv = ["--recipe", "robust", "--env", "usv-simple", "--seed", "7", "--num-envs", "4",
            "--device", "cpu"] + (["--train-freq", "8", "--buffer-size", "64"] if learner == "sac" else [])
    bundle = export_fresh_policy(learner, argv, tmp_path / "fresh")
    runner, cls, config = ((run_sac, SacLearner, "sac_config") if learner == "sac"
                           else (run_ppo, PpoLearner, "ppo_config"))
    args = runner.apply_recipe(runner.build_parser().parse_args(argv))
    ts = cls(make("usv-simple", device="cpu"), getattr(runner, config)(args)).init(seed=7)
    fresh = (ts.actor if learner == "sac" else ts.model).state_dict()
    saved = torch.load(Path(bundle) / "params.pt")
    assert saved.keys() == fresh.keys()
    for k in fresh:
        assert torch.equal(saved[k], fresh[k]), k
    assert json.loads((Path(bundle) / "policy.json").read_text())["kind"] == learner


def test_study_loads_no_jax_and_no_usv_tpu(study):
    assert study["loaded"] == []

"""The port's PPO seed study (``usv_tpu_torch/tools/study_ppo_k4_seeds.py``)
against the JAX package's (``tools/study_ppo_k4_seeds.py``), on the CPU.

A tiny study (2 seeds, 4 envs, 2 iterations of 64 env-steps, an in-run
eval every iteration) runs once in a subprocess that also lists the modules
it loaded, and once as two single-seed processes side by side
(``tools/side_by_side.py``). Then:

* the artifact's key tree (the port's keys set aside) equals the one the
  JAX study writes, and holds every key of the JAX record
  ``docs/artifacts/ppo_k4_seed_study_r4_global.json``;
* with ``run_ppo.main`` and ``bundle_eval`` stubbed in both studies, the
  argument lists handed to ``run_ppo.main``, the bundles scored (the
  ``policy_best`` -> ``policy`` fallback), ``protocol``, the rounding and
  the statistics (mean, std with n - 1, floor) are the JAX study's;
* ``combine`` of the two single-seed artifacts equals the two-seed run,
  each seed's evals equal to the digit;
* ``untrained_floor`` scores, per seed, the recipe's fresh actor-critic:
  the weights ``PpoLearner.init(seed)`` makes;
* the run loaded no ``jax``, ``flax`` and no ``usv_tpu`` module.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from usv_tpu_torch.tools import study_ppo_k4_seeds as study
from usv_tpu_torch.train import evaluate, run_ppo

REPO = Path(__file__).resolve().parents[1]
JAX_RECORD = REPO / "docs" / "artifacts" / "ppo_k4_seed_study_r4_global.json"
PORT_KEYS = {"device", "untrained_floor", "side_by_side", "curves", "trained_env_steps"}
TRAIN_ARGS = ["--num-envs", "4", "--n-steps", "16", "--batch-size", "16",
              "--eval-every-iters", "1", "--eval-envs", "4"]


def common_flags():
    return ["--total-steps", "128", "--env", "usv-simple", "--best-metric", "reward",
            "--eval-steps", "8", "--eval-episodes", "4", "--eval-seeds", "2"] + \
        [f"--train-arg={a}" for a in TRAIN_ARGS]


def study_flags(outdir, artifact, seeds=2, offset=0):
    return ["--seeds", str(seeds), "--seed-offset", str(offset), "--outdir", str(outdir),
            "--artifact", str(artifact)] + common_flags()


_RUN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from usv_tpu_torch.tools import study_ppo_k4_seeds
study_ppo_k4_seeds.main(json.loads(sys.argv[1]))
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax", "usv_tpu"))
print("LOADED " + json.dumps(loaded))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from usv_tpu_torch.tools import side_by_side

    tmp = tmp_path_factory.mktemp("ppo_study")
    argv = study_flags(tmp / "serial", tmp / "serial.json") + ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    serial = subprocess.Popen([sys.executable, "-c", _RUN, json.dumps(argv)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the same two seeds as two single-seed processes at once
    report = side_by_side.launch(0, 2, tmp / "side", common_flags(), device="cpu")
    out, err = serial.communicate(timeout=300)
    assert serial.returncode == 0, err[-4000:]
    return dict(artifact=json.loads((tmp / "serial.json").read_text()),
                loaded=json.loads(out.split("LOADED ")[-1]), outdir=tmp / "serial",
                side=report, side_dir=tmp / "side")


def key_tree(x):
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [key_tree(x[0])] if x else []
    return None


def holds_keys(tree, record):
    """Every key of ``record``'s tree is in ``tree``'s."""
    if isinstance(record, dict):
        return isinstance(tree, dict) and all(k in tree and holds_keys(tree[k], v) for k, v in record.items())
    if isinstance(record, list) and record:
        return isinstance(tree, list) and bool(tree) and holds_keys(tree[0], record[0])
    return True


def jax_study():
    spec = importlib.util.spec_from_file_location("jax_study_ppo_k4_seeds",
                                                  REPO / "tools" / "study_ppo_k4_seeds.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fake_evals(bundle, seed):
    """An injected eval with more decimals than the artifact keeps."""
    trained = Path(bundle).name != "policy_init"
    run_seed = int(Path(bundle).parent.name.removeprefix("seed"))
    return {"reward_per_step": 0.1234567 * run_seed + 0.0107311 * seed + (1.0 if trained else 0.0)}


def stubbed_run(monkeypatch, tmp, module, flags, runner, evaluator):
    """Run the study ``module`` with its trainer and ``bundle_eval`` stubbed: the
    trainer writes a bundle (``policy_best`` for even seeds, only
    ``policy`` for odd ones) and one metrics line. Returns (artifact,
    trainer argument lists, bundles scored)."""
    calls, scored = [], []

    def fake_main(argv):
        calls.append([a.replace(str(tmp), "<tmp>") for a in argv])
        logdir = Path(argv[argv.index("--logdir") + 1])
        seed = int(argv[argv.index("--seed") + 1])
        name = "policy_best" if seed % 2 == 0 else "policy"
        (logdir / name).mkdir(parents=True)
        (logdir / name / "policy.json").write_text("{}")
        total = int(float(argv[argv.index("--total-steps") + 1]))
        (logdir / "metrics.jsonl").write_text(json.dumps(dict(step=total, mean_reward=0.5)) + "\n")

    def fake_bundle_eval(env_id, bundle, *, seed=0, **kw):
        scored.append(str(Path(bundle).relative_to(tmp)))
        return fake_evals(bundle, seed)

    monkeypatch.setattr(runner, "main", fake_main)
    monkeypatch.setattr(evaluator, "bundle_eval", fake_bundle_eval)
    artifact = tmp / "artifact.json"
    if module is study:
        # the fresh network is built on the CPU; the trainer's flags are checked without it
        monkeypatch.setattr(study, "export_fresh_policy",
                            lambda learner, argv, path: str(path))
        study.main(flags + ["--device", "cpu"])
    else:
        monkeypatch.setattr(sys, "argv", ["study_ppo_k4_seeds.py"] + flags)
        module.main()
    return json.loads(artifact.read_text()), calls, [s for s in scored if "policy_init" not in s]


@pytest.fixture(scope="module")
def jax_stubbed(tmp_path_factory):
    pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")
    from usv_tpu.train import evaluate as jevaluate
    from usv_tpu.train import run_ppo as jrun_ppo

    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("jax_stubbed")
    try:
        yield stubbed_run(mp, tmp, jax_study(), study_flags(tmp / "runs", tmp / "artifact.json",
                                                             seeds=3, offset=4),
                          jrun_ppo, jevaluate)
    finally:
        mp.undo()


@pytest.fixture
def port_stubbed(tmp_path, monkeypatch):
    return stubbed_run(monkeypatch, tmp_path, study,
                       study_flags(tmp_path / "runs", tmp_path / "artifact.json", seeds=3, offset=4),
                       run_ppo, evaluate)


def test_artifact_has_the_jax_studys_key_tree(runs, jax_stubbed):
    art = runs["artifact"]
    assert PORT_KEYS <= set(art)
    ours = key_tree({k: v for k, v in art.items() if k not in PORT_KEYS})
    assert ours == key_tree(jax_stubbed[0])
    assert holds_keys(ours, json.loads(JAX_RECORD.read_text()))
    assert art["device"] == "cpu" and art["side_by_side"] == 1
    assert art["seed_range"] == "0..1" and art["note"] is None
    assert art["trained_env_steps"] == {"0": 128, "1": 128}


def test_trainer_flags_bundles_and_protocol_match_the_jax_study(port_stubbed, jax_stubbed):
    port_art, port_calls, port_scored = port_stubbed
    jax_art, jax_calls, jax_scored = jax_stubbed
    assert len(port_calls) == len(jax_calls) == 3
    for ours, theirs in zip(port_calls, jax_calls):
        i = ours.index("--device")
        assert ours[i:i + 2] == ["--device", "cpu"]
        assert ours[:i] + ours[i + 2:] == theirs
    # seeds 4 and 6 exported policy_best; seed 5's run only its final policy
    assert port_scored == jax_scored == [f"runs/seed{s}/{b}" for s, b in
                                         ((4, "policy_best"), (5, "policy"), (6, "policy_best"))
                                         for _ in range(2)]
    assert port_art["protocol"] == jax_art["protocol"]


def test_statistics_and_rounding_follow_the_jax_study(port_stubbed, jax_stubbed):
    port_art, jax_art = port_stubbed[0], jax_stubbed[0]
    for art in (port_art, jax_art):
        for rec in art["per_seed"]:
            rec["train_seconds"] = 0.0
    assert {k: v for k, v in port_art.items() if k not in PORT_KEYS} == jax_art
    means = [r["reward_per_step_mean"] for r in port_art["per_seed"]]
    mu = sum(means) / 3
    assert port_art["mean"] == round(mu, 4)
    assert port_art["std"] == round((sum((m - mu) ** 2 for m in means) / 2) ** 0.5, 4)
    assert port_art["floor"] == min(means) == means[0]
    assert port_art["seed_range"] == "4..6" and port_art["note"].startswith("EXTENSION")
    assert port_art["per_seed"][1]["evals"] == [{"reward_per_step": round(1.0 + 0.1234567 * 5 + 0.0107311 * s, 4)}
                                                for s in range(2)]
    assert [f["seed"] for f in port_art["untrained_floor"]] == [4, 5, 6]
    assert port_art["untrained_floor"][0]["reward_per_step_mean"] == round(0.1234567 * 4 + 0.0107311 / 2, 4)


def test_combine_of_single_seed_runs_equals_the_two_seed_run(runs):
    serial, side = runs["artifact"], runs["side"]["artifact"]
    assert side["side_by_side"] == 2 and runs["side"]["processes"] == 2
    for key in ("per_seed", "untrained_floor"):
        strip = [{k: v for k, v in r.items() if k != "train_seconds"} for r in serial[key]]
        assert [{k: v for k, v in r.items() if k != "train_seconds"} for r in side[key]] == strip
    for key in ("mean", "std", "floor", "seeds", "seed_offset", "seed_range", "note", "protocol",
                "train_arg", "total_steps", "curves"):
        assert side[key] == serial[key], key
    combined = study.combine([runs["side_dir"] / "seed1.json", runs["side_dir"] / "seed0.json"])
    assert combined == dict(side, side_by_side=2)
    for seed, rec in runs["side"]["per_seed"].items():
        assert len(rec["iteration_seconds"]) == 2 and rec["launches"] == 0, seed


def test_combine_refuses_artifacts_of_other_studies(runs, tmp_path):
    other = json.loads((runs["side_dir"] / "seed1.json").read_text())
    other["total_steps"] = 256.0
    (tmp_path / "other.json").write_text(json.dumps(other))
    with pytest.raises(ValueError, match="total_steps"):
        study.combine([runs["side_dir"] / "seed0.json", tmp_path / "other.json"])
    with pytest.raises(ValueError, match="contiguous"):
        study.combine([runs["side_dir"] / "seed0.json", runs["side_dir"] / "seed0.json"])


def test_real_run_scores_policy_best_and_its_curve(runs):
    art = runs["artifact"]
    for rec in art["per_seed"]:
        logdir = runs["outdir"] / f"seed{rec['seed']}"
        assert (logdir / "policy_best" / "policy.json").exists()
        got = evaluate.bundle_eval("usv-simple", str(logdir / "policy_best"), steps=8, episodes=4,
                                   seed=1, device="cpu")
        assert rec["evals"][1] == {"reward_per_step": round(got["reward_per_step"], 4)}
        assert [p[0] for p in art["curves"][str(rec["seed"])]] == [64, 128]


def test_untrained_floor_scores_the_fresh_actor_critic_of_each_seed(runs):
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.ppo import PpoLearner

    floors = runs["artifact"]["untrained_floor"]
    assert [f["seed"] for f in floors] == [0, 1]
    for f in floors:
        argv = ["--recipe", "at-scale", "--total-steps", "128", "--seed", str(f["seed"])] + TRAIN_ARGS
        args = run_ppo.apply_recipe(run_ppo.build_parser().parse_args(argv))
        fresh = PpoLearner(make("usv-simple", device="cpu"), run_ppo.ppo_config(args)).init(
            seed=f["seed"]).model.state_dict()
        bundle = runs["outdir"] / f"seed{f['seed']}" / "policy_init"
        saved = torch.load(bundle / "params.pt")
        assert saved.keys() == fresh.keys()
        for k in fresh:
            assert torch.equal(saved[k], fresh[k]), k
        got = evaluate.bundle_eval("usv-simple", str(bundle), steps=8, episodes=4, seed=0, device="cpu")
        assert f["evals"][0] == {"reward_per_step": round(got["reward_per_step"], 4)}


def test_study_loads_no_jax_and_no_usv_tpu(runs):
    assert runs["loaded"] == []


@pytest.mark.parametrize("port, expected", [
    ([1.6, 1.3, 0.9, 1.7, 1.4], "pass"),
    ([1.0, 0.95, 0.9, 1.05, 1.0], "suspect"),
    ([0.7, 0.75, 0.8, 0.78, 0.72], "fail"),
])
def test_verdict_is_the_one_sided_welch_rule(port, expected):
    from scipy import stats

    reference = [1.6087, 1.314, 0.7997, 1.8216, 1.4324, 1.5785, 0.7897, 1.4992, 1.467, 1.5848]
    got = study.verdict(port, reference, floor=0.7997)
    want = stats.ttest_ind(port, reference, equal_var=False, alternative="less")
    assert got["t"] == pytest.approx(want.statistic, rel=1e-12)
    assert got["p_one_sided"] == pytest.approx(want.pvalue, rel=1e-9)
    assert got["verdict"] == expected


def test_a_stopped_seed_is_scored_as_its_finished_run(runs, tmp_path):
    """``side_by_side.truncated_artifact`` (what ``--stop-at`` writes for a
    process it stopped) on a finished seed's files: its policy_best, floor
    and curve give the run's own record."""
    import shutil

    from usv_tpu_torch.tools import side_by_side

    shutil.copytree(runs["side_dir"], tmp_path / "side")
    finished = json.loads((tmp_path / "side" / "seed1.json").read_text())
    art = side_by_side.truncated_artifact(1, tmp_path / "side", common_flags(), "cpu")
    assert art == json.loads((tmp_path / "side" / "seed1.json").read_text())
    for key in ("per_seed", "untrained_floor"):
        drop = [{k: v for k, v in r.items() if k != "train_seconds"} for r in finished[key]]
        assert [{k: v for k, v in r.items() if k != "train_seconds"} for r in art[key]] == drop
    assert art["curves"] == finished["curves"] and art["seed_range"] == "1..1"


def test_a_launch_stops_at_its_time_and_marks_the_seed_truncated(runs, tmp_path):
    """``--stop-at``: the process still running then is stopped, its seed
    scored on its last whole ``policy_best``, and the artifact records how
    far it trained; ``combine`` with another seed keeps each seed's mark."""
    from usv_tpu_torch.tools import side_by_side

    flags = common_flags()
    flags[flags.index("--total-steps") + 1] = str(64 * 10000)
    # half again a finished two-iteration process's wall: some iterations in
    stop_at = 1.5 * max(r["wall_seconds"] for r in runs["side"]["per_seed"].values())
    report = side_by_side.launch(1, 1, tmp_path, flags, device="cpu", stop_at=stop_at)
    art = report["artifact"]
    trained = art["trained_env_steps"]["1"]
    assert report["stopped"] == [1] and 64 <= trained < 64 * 10000
    assert trained == art["curves"]["1"][-1][0] and trained % 64 == 0
    truncated = (f"TRUNCATED: seeds [1] stopped at {trained}-{trained} of --total-steps 640000 "
                 "env-steps; each scores the policy_best of its last in-run eval")
    # seed 1 alone is also an extension of the study
    assert art["note"].startswith("EXTENSION") and art["note"].endswith(" " + truncated)
    # seed 0's 128 env-steps, under this study's budget, are a truncation too
    finished = json.loads((runs["side_dir"] / "seed0.json").read_text())
    finished["total_steps"] = art["total_steps"]
    (tmp_path / "finished.json").write_text(json.dumps(finished))
    both = study.combine([tmp_path / "finished.json", tmp_path / "seed1.json"])
    assert both["trained_env_steps"] == {"0": 128, "1": trained}
    assert both["note"] == truncated.replace("[1]", "[0, 1]").replace(f"at {trained}-", "at 128-")


@pytest.mark.parametrize("cut", ["none", "params older", "params cut short", "json cut short"])
def test_only_a_whole_bundle_is_scored(runs, tmp_path, cut):
    """A bundle is whole when both files parse and ``params.pt`` was written
    after ``policy.json``, as ``export_policy`` writes them."""
    import os
    import shutil

    from usv_tpu_torch.tools import side_by_side

    bundle = tmp_path / "policy_best"
    shutil.copytree(runs["outdir"] / "seed0" / "policy_best", bundle)
    meta, params = bundle / "policy.json", bundle / "params.pt"
    if cut == "params older":
        st = meta.stat()
        os.utime(params, ns=(st.st_atime_ns, st.st_mtime_ns - 1))
    elif cut == "params cut short":
        params.write_bytes(params.read_bytes()[:-100])
    elif cut == "json cut short":
        text = meta.read_text()
        meta.write_text(text[: len(text) // 2])
        os.utime(params)
    assert side_by_side.whole_bundle(bundle) == (cut == "none")

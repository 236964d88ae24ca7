"""The port's train CLIs (``train/run_sac.py``, ``train/run_ppo.py``) and
``run_eval --replay-recorded-eval``, on the CPU at tiny budgets.

* Both CLIs write ``policy``, ``policy_best`` (with its in-run eval record)
  and ``ckpt`` with ``--device cpu``; ``run_eval --replay-recorded-eval``
  replays the record exactly; an SAC run stopped and ``--resume``d ends bit
  for bit where an uninterrupted run ends (light checkpoints resume too).
* Both ``apply_recipe``s resolve a table of flag sets as the JAX package's.
* The flag combinations the JAX CLIs refuse are parser errors (a seed
  population with ``--shard`` or ``--shard-local-replay``, the robust recipe
  included, names the data-parallel layer); without ``--device`` the CLIs
  run on the card and raise without one.
"""

import argparse
import json

import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")

from usv_tpu.train import run_ppo as jrun_ppo
from usv_tpu.train import run_sac as jrun_sac
from usv_tpu_torch.envs import make
from usv_tpu_torch.train import checkpoint, run_eval, run_ppo, run_sac

SAC_TINY = ["--env", "usv-simple", "--num-envs", "4", "--train-freq", "2", "--gradient-steps", "2",
            "--batch-size", "16", "--buffer-size", "64", "--learning-starts", "8",
            "--rounds-per-block", "2", "--eval-every-blocks", "1", "--eval-steps", "5",
            "--eval-envs", "2", "--checkpoint-every-blocks", "2", "--frame-stack", "2",
            "--device", "cpu"]
PPO_TINY = ["--env", "usv-simple", "--num-envs", "4", "--n-steps", "8", "--batch-size", "16",
            "--eval-every-iters", "1", "--eval-steps", "5", "--eval-envs", "2",
            "--checkpoint-every-iters", "1", "--watch-every-iters", "1", "--frame-stack", "2",
            "--device", "cpu"]


def _same_params(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_run_sac_writes_bundles_checkpoints_and_resumes_exactly(tmp_path, capsys):
    logdir = tmp_path / "sac"
    learner, ts = run_sac.main(SAC_TINY + ["--total-steps", "48", "--logdir", str(logdir)])
    assert ts.env_steps * 4 == 48 and ts.grad_steps > 0
    for name in ("policy", "policy_best"):
        assert (logdir / name / "policy.json").exists() and (logdir / name / "params.pt").exists()
    assert sorted(p.name for p in (logdir / "ckpt").iterdir()) == ["32", "48"]
    lines = [json.loads(x) for x in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [x["env_steps"] for x in lines] == [16, 32, 48]
    assert {"eval_reward_per_step", "critic_grad_norm", "alpha"} <= set(lines[-1])
    best = json.loads((logdir / "policy_best" / "policy.json").read_text())
    assert best["kind"] == "sac" and best["hidden"] == [400, 300] and "seed" in best["in_run_eval"]

    # the recorded in-run eval replays exactly through run_eval
    run_eval.main(["--env", "usv-simple", "--policy", str(logdir / "policy_best"), "--steps", "3",
                   "--episodes", "2", "--out", str(tmp_path / "ev"), "--device", "cpu",
                   "--replay-recorded-eval"])
    rep = json.loads((tmp_path / "ev" / "replay_recorded_eval.json").read_text())
    assert rep["exact_match"] and rep["recorded"] == rep["replayed"]
    capsys.readouterr()

    # stopped at 48 steps and resumed to 64 == one run to 64
    _, resumed = run_sac.main(SAC_TINY + ["--total-steps", "64", "--logdir", str(logdir), "--resume"])
    assert "resumed from checkpoint at env step 48" in capsys.readouterr().out
    _, straight = run_sac.main(SAC_TINY + ["--total-steps", "64", "--logdir", str(tmp_path / "straight")])
    assert resumed.env_steps == straight.env_steps == 16
    assert resumed.grad_steps == straight.grad_steps
    assert _same_params(resumed.actor, straight.actor) and _same_params(resumed.critic, straight.critic)
    assert torch.equal(resumed.buffer.obs, straight.buffer.obs)

    # light checkpoints: no buffer in the file, a resume re-warms an empty one
    light = tmp_path / "light"
    run_sac.main(SAC_TINY + ["--total-steps", "32", "--logdir", str(light), "--light-checkpoints"])
    saved = torch.load(light / "ckpt" / "32" / checkpoint.FILE, weights_only=True)
    assert saved["state"]["buffer"] is None and saved["step"] == 32
    _, ts = run_sac.main(SAC_TINY + ["--total-steps", "48", "--logdir", str(light), "--resume",
                                     "--light-checkpoints"])
    assert ts.env_steps == 12 and ts.buffer.size == 16


def test_run_ppo_writes_bundles_and_checkpoints(tmp_path):
    logdir = tmp_path / "ppo"
    learner, ts = run_ppo.main(PPO_TINY + ["--total-steps", "64", "--logdir", str(logdir)])
    assert ts.update_count == 2 and ts.opt_steps == 2 * 10 * 2
    for name in ("policy", "policy_best"):
        assert (logdir / name / "policy.json").exists()
    assert sorted(p.name for p in (logdir / "ckpt").iterdir()) == ["32", "64"]
    restored, step = checkpoint.restore_checkpoint(logdir / "ckpt", learner.init(9))
    assert step == 64 and restored.update_count == 2 and _same_params(restored.model, ts.model)
    lines = [json.loads(x) for x in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert {"param_norm", "log_std_mean", "eval_reward_per_step", "mean_reward"} <= set(lines[-1])
    best = json.loads((logdir / "policy_best" / "policy.json").read_text())
    assert best["kind"] == "ppo" and best["pi_hidden"] == [256, 256]
    run_eval.main(["--env", "usv-simple", "--policy", str(logdir / "policy_best"), "--steps", "3",
                   "--episodes", "2", "--out", str(tmp_path / "ev"), "--device", "cpu",
                   "--replay-recorded-eval"])
    assert json.loads((tmp_path / "ev" / "replay_recorded_eval.json").read_text())["exact_match"]


SAC_RECIPES = [[], ["--recipe", "at-scale"], ["--recipe", "at-scale", "--update-fusion", "1", "--lr", "1e-4"],
               ["--recipe", "robust"], ["--recipe", "robust", "--buffer-size", "50000", "--population", "2"],
               ["--num-envs", "64", "--train-freq", "4"]]
PPO_RECIPES = [[], ["--recipe", "at-scale", "--total-steps", "100e6"],
               ["--recipe", "at-scale", "--update-fusion", "1"],
               ["--recipe", "at-scale", "--no-single-shuffle", "--total-steps", "100e6"],
               ["--recipe", "at-scale", "--env", "usv-asmc-ca-v0"],
               ["--recipe", "at-scale", "--env", "usv-asmc-ca-v0", "--update-fusion", "4"],
               ["--recipe", "at-scale", "--env", "usv-asmc-ca-v0", "--n-steps", "64", "--total-steps", "32768"],
               ["--recipe", "robust", "--batch-size", "512"]]
SAC_FIELDS = ("num_envs", "train_freq", "gradient_steps", "update_fusion", "lr", "population", "buffer_size")
PPO_FIELDS = ("num_envs", "batch_size", "update_fusion", "single_shuffle", "eval_steps",
              "lr_decay_updates", "population")


@pytest.mark.parametrize("argv", SAC_RECIPES, ids=lambda a: " ".join(a) or "none")
def test_sac_recipe_resolution_matches_jax(argv):
    parsed = run_sac.build_parser().parse_args(argv)
    # the JAX CLI builds its parser inside main: hand its apply_recipe the
    # same sentinels (as tests/test_train.py does)
    want = jrun_sac.apply_recipe(argparse.Namespace(**{k: getattr(parsed, k)
                                                       for k in ("recipe",) + SAC_FIELDS}))
    got = run_sac.apply_recipe(parsed)
    assert [getattr(got, k) for k in SAC_FIELDS] == [getattr(want, k) for k in SAC_FIELDS]


@pytest.mark.parametrize("argv", PPO_RECIPES, ids=lambda a: " ".join(a) or "none")
def test_ppo_recipe_resolution_matches_jax(argv):
    got = run_ppo.apply_recipe(run_ppo.build_parser().parse_args(argv))
    jp = jrun_ppo.build_parser()
    want = jrun_ppo.apply_recipe(jp.parse_args(argv), jp)
    assert [getattr(got, k) for k in PPO_FIELDS] == [getattr(want, k) for k in PPO_FIELDS]
    # every flag of the JAX parser exists here, with its default
    ours = vars(run_ppo.build_parser().parse_args([]))
    assert set(vars(jp.parse_args([]))) <= set(ours) and set(ours) - set(vars(jp.parse_args([]))) == {"device"}


@pytest.mark.parametrize("cli,argv,word", [
    (run_sac, ["--population", "2", "--shard-local-replay"], "data-parallel"),
    (run_sac, ["--recipe", "robust", "--shard"], "data-parallel"),
    (run_sac, ["--population", "2", "--shard"], "incompatible with --shard"),
    (run_ppo, ["--rotate-groups"], "--shuffle-groups"),
    (run_eval, ["--replay-recorded-eval"], "--policy"),
])
def test_waiting_flags_are_parser_errors(cli, argv, word, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2 and word in capsys.readouterr().err


def test_clis_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    for cli, argv in ((run_sac, ["--total-steps", "1"]), (run_ppo, ["--total-steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv + ["--logdir", str(tmp_path / cli.__name__)])
    assert make("usv-simple", device="cpu").device == torch.device("cpu")

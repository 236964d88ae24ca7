"""Multi-invocation band study of ``--recipe robust`` for either learner —
port of ``tools/study_robust_band.py``.

Runs N invocations of ``run_{sac,ppo} --recipe robust`` with disjoint base
seeds (invocation i trains the population base + 100 i, base + 100 i + 1,
...), scores every exported winner bundle (``policy_best``) with
``evaluate.bundle_eval`` once for each of ``--eval-seeds`` eval seeds, and
writes the JAX study's artifact: per-invocation walls, eval stats and the
population's selection table, with the band's mean, std and floor.

Two keys are the port's own: ``device`` (the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them,
or ``"cpu"``) and ``untrained_floor`` (per invocation, the recipe's freshly
initialised network, init seed = base seed, scored by the same protocol: how
far training moved the score).

Usage (on the card unless ``--device`` names another; a population run
cannot ``--resume``, so each invocation finishes in this process):

    python -m usv_tpu_torch.tools.study_robust_band --learner sac \\
        --env usv-simple --invocations 1 --total-steps 1e8 \\
        --base-seed-start 9500 --best-metric reward --eval-steps 1000 \\
        --artifact docs/artifacts/torch_sac_robust_budget_100m_h100.json

After each invocation it prints the invocation's record and its curve: the
collect reward per step of every block of ``metrics.jsonl`` against the
env-steps per seed, beside each seed's in-run best eval.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
import types
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--learner", choices=["sac", "ppo"], required=True)
    p.add_argument("--env", default="usv-simple")
    p.add_argument("--invocations", type=int, default=3)
    p.add_argument("--total-steps", type=float, default=400e6)
    p.add_argument("--base-seed-start", type=int, default=9000,
                   help="invocation i uses base seed start + 100*i "
                        "(populations of 4 consume base..base+3 — disjoint)")
    p.add_argument("--best-metric", choices=["reward", "arrivals"], default="reward")
    p.add_argument("--eval-steps", type=int, default=1000)
    p.add_argument("--eval-episodes", type=int, default=16)
    p.add_argument("--eval-seeds", type=int, default=3)
    p.add_argument("--train-arg", action="append", default=[])
    p.add_argument("--outdir", default="runs/robust_band_r5")
    p.add_argument("--artifact", required=True)
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def device_line(device) -> str:
    """``"cpu"``, or the card's ``name, power limit`` line from nvidia-smi."""
    import torch

    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def export_fresh_policy(learner_name, train_argv, path) -> str:
    """Export the network that ``run_<learner_name>.main(train_argv)``
    starts from: the recipe's learner, initialised from its ``--seed`` as
    ``init`` and ``init_many`` initialise it, saved as a bundle at ``path``."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.common import seeded_init
    from usv_tpu_torch.train.policy import export_policy

    if learner_name == "sac":
        from usv_tpu_torch.train import run_sac as runner
        from usv_tpu_torch.train.sac import SacLearner as Learner
    else:
        from usv_tpu_torch.train import run_ppo as runner
        from usv_tpu_torch.train.ppo import PpoLearner as Learner
    args = runner.apply_recipe(runner.build_parser().parse_args(train_argv))
    env_kwargs = {"ignore_obstacles": True} if args.ignore_obstacles else {}
    handle = make(args.env, device=args.device, **env_kwargs)
    if learner_name == "sac":
        learner = Learner(handle, runner.sac_config(args))
        build = learner.build_actor
    else:
        learner = Learner(handle, runner.ppo_config(args))
        build = learner.build_model
    with seeded_init(args.seed):
        net = build().to(handle.device)
    return export_policy(learner, types.SimpleNamespace(actor=net, model=net), path)


def score_bundle(args, bundle) -> tuple:
    """``bundle_eval`` once for each eval seed: ``(evals, {<stat>_mean})``,
    rounded as the JAX study rounds them."""
    from usv_tpu_torch.train.evaluate import bundle_eval

    evals = [
        bundle_eval(args.env, str(bundle), best_metric=args.best_metric,
                    steps=args.eval_steps, episodes=args.eval_episodes, seed=es,
                    device=args.device)
        for es in range(args.eval_seeds)
    ]
    means = {f"{k}_mean": round(float(np.mean([e[k] for e in evals])), 4) for k in evals[0]}
    return [{k: round(v, 4) for k, v in e.items()} for e in evals], means


def curve(logdir) -> list:
    """``[env-steps per seed, collect reward per step]`` of every logged
    block (PPO logs its iterations' mean reward)."""
    lines = Path(logdir, "metrics.jsonl").read_text().splitlines()
    recs = [json.loads(x) for x in lines if x.strip()]
    return [[r["step"], r.get("collect_reward_per_step", r.get("mean_reward"))] for r in recs]


def main(argv=None) -> dict:
    """Run the study; writes ``--artifact`` and returns its contents."""
    args = build_parser().parse_args(argv)
    if args.learner == "sac":
        from usv_tpu_torch.train import run_sac as runner
    else:
        from usv_tpu_torch.train import run_ppo as runner

    score_key = "arrival_rate" if args.best_metric == "arrivals" else "reward_per_step"
    device_flag = [] if args.device is None else ["--device", args.device]
    invocations, floors = [], []
    for i in range(args.invocations):
        base = args.base_seed_start + 100 * i
        logdir = f"{args.outdir}/{args.learner}_{args.env}_b{base}"
        train_argv = [
            "--recipe", "robust",
            "--env", args.env,
            "--total-steps", str(args.total_steps),
            "--seed", str(base),
            "--best-metric", args.best_metric,
            "--eval-steps", str(args.eval_steps),
            "--logdir", logdir,
        ] + device_flag + args.train_arg

        fresh = export_fresh_policy(args.learner, train_argv, Path(logdir) / "policy_init")
        evals, means = score_bundle(args, fresh)
        floors.append(dict(base_seed=base, evals=evals, **means))
        print(json.dumps({"untrained_floor": floors[-1]}), flush=True)

        t0 = time.time()
        runner.main(train_argv)
        wall = time.time() - t0

        bundle = Path(logdir) / "policy_best"
        meta = json.loads((bundle / "policy.json").read_text())
        pop = meta.get("population", {})
        evals, means = score_bundle(args, bundle)
        rec = dict(
            base_seed=base,
            winner_seed=pop.get("winner_seed"),
            wall_seconds=round(wall, 1),
            evals=evals,
            selection=pop.get("selection"),
            **means,
        )
        invocations.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "selection"}), flush=True)
        print(json.dumps(dict(
            curve=base, env_steps_per_seed_and_reward=curve(logdir),
            in_run_best={s["seed"]: s["in_run_best"] for s in pop.get("selection") or []},
        )), flush=True)

    key = f"{score_key}_mean"
    means = [r[key] for r in invocations]
    out = dict(
        command=(f"run_{args.learner} --recipe robust --env {args.env} "
                 f"--total-steps {args.total_steps:g} --seed <base> "
                 f"--best-metric {args.best_metric} "
                 f"--eval-steps {args.eval_steps} "
                 + " ".join(args.train_arg)),
        env=args.env,
        learner=args.learner,
        total_steps_per_seed=args.total_steps,
        invocations=invocations,
        score_key=score_key,
        mean=round(float(np.mean(means)), 4),
        std=round(float(np.std(means, ddof=1)) if len(means) > 1 else 0.0, 4),
        floor=round(min(means), 4),
        max_wall_seconds=max(r["wall_seconds"] for r in invocations),
        protocol=(f"winner bundle via evaluate.bundle_eval, "
                  f"{args.eval_episodes} envs x {args.eval_steps} "
                  f"deterministic steps, {args.eval_seeds} eval seeds"),
        device=device_line(args.device),
        untrained_floor=floors,
    )
    Path(args.artifact).parent.mkdir(parents=True, exist_ok=True)
    Path(args.artifact).write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.artifact}: {key} mean {out['mean']} ± {out['std']} "
          f"floor {out['floor']}", flush=True)
    return out


if __name__ == "__main__":
    main()

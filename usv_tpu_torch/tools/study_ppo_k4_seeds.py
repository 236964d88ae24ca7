"""Multi-seed quality study of a PPO recipe — port of
``tools/study_ppo_k4_seeds.py``.

Runs ``run_ppo --recipe <recipe>`` once per seed (``--seed-offset`` ..
``--seed-offset + --seeds - 1``), re-evaluates each exported ``policy_best``
bundle (``policy`` when no in-run eval fired) with
``evaluate.bundle_eval`` once for each of ``--eval-seeds`` eval seeds, and
writes the JAX study's artifact: per-seed train seconds, evals and means,
with the study's mean, sample std (n - 1) and floor.

The port's own keys: ``device`` (the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, or ``"cpu"``), ``untrained_floor`` (per seed, the recipe's freshly
initialised actor-critic of that seed, scored by the same protocol),
``side_by_side`` (how many study processes ran the study's seeds at once
on the device: 1 for one process, the count :func:`combine` is given for
artifacts made by concurrent processes), ``curves`` (per seed, the
collect reward of every iteration of ``metrics.jsonl`` against env-steps)
and ``trained_env_steps`` (per seed, the env-steps it trained: under
``--total-steps`` for a seed stopped early, which ``note`` then names as
TRUNCATED).

Usage (on the card unless ``--device`` names another):

    python -m usv_tpu_torch.tools.study_ppo_k4_seeds --seeds 5 \\
        --total-steps 1e8 --env usv-simple --best-metric reward --eval-steps 1000

Seeds may run side by side, one process each with its own ``--outdir`` and
``--artifact`` (``--seeds 1 --seed-offset k``): training on the card is
deterministic, so each seed scores what it scores in series. Then
``combine([artifact, ...], side_by_side=n)`` rebuilds the study's artifact
from the single-seed ones.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from usv_tpu_torch.tools.study_robust_band import curve, device_line, export_fresh_policy

# the keys that every artifact combined into one study must share
SHARED_KEYS = ("recipe", "train_arg", "env", "best_metric", "total_steps", "score_key", "protocol")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--seed-offset", type=int, default=0,
                   help="first seed (extend an existing study without re-running its seeds)")
    p.add_argument("--total-steps", type=float, default=100e6)
    p.add_argument("--env", default="usv-simple")
    p.add_argument("--recipe", default="at-scale")
    p.add_argument("--best-metric", choices=["reward", "arrivals"], default="reward")
    p.add_argument("--eval-steps", type=int, default=1000,
                   help="bundle re-eval rollout length (CA episodes run to 5000 steps)")
    p.add_argument("--eval-episodes", type=int, default=16)
    p.add_argument("--eval-seeds", type=int, default=3,
                   help="re-eval each bundle across this many eval seeds")
    p.add_argument("--train-arg", action="append", default=[],
                   help="extra run_ppo flag, repeatable (e.g. --train-arg=--shuffle-groups "
                        "--train-arg=8)")
    p.add_argument("--outdir", default="runs/ppo_seed_study")
    p.add_argument("--artifact", default=None,
                   help="default runs/ppo_seed_study/summary[_offset<k>].json, never a "
                        "committed artifact")
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def train_argv(args, seed, logdir) -> list:
    """The ``run_ppo.main`` argument list of one seed: the JAX study's, with
    ``--device`` before the ``--train-arg`` tokens when it is given."""
    device_flag = [] if args.device is None else ["--device", args.device]
    return [
        "--recipe", args.recipe,
        "--env", args.env,
        "--total-steps", str(args.total_steps),
        "--seed", str(seed),
        "--best-metric", args.best_metric,
        "--eval-steps", str(args.eval_steps),
        "--logdir", logdir,
        "--checkpoint-every-iters", "0",
        "--video-every-iters", "0",
    ] + device_flag + args.train_arg


def protocol(eval_episodes, eval_steps, eval_seeds) -> str:
    return (f"best-eval export bundle, {eval_episodes} envs x {eval_steps} deterministic "
            f"steps, mean over {eval_seeds} eval seeds")


def score(args, bundle) -> dict:
    """``bundle_eval`` once for each eval seed, rounded as the JAX study
    rounds: ``{"evals": [...], "<stat>_mean": ...}`` (each mean over the
    unrounded evals)."""
    from usv_tpu_torch.train.evaluate import bundle_eval

    evals = [
        bundle_eval(args.env, str(bundle), best_metric=args.best_metric, steps=args.eval_steps,
                    episodes=args.eval_episodes, seed=es, device=args.device)
        for es in range(args.eval_seeds)
    ]
    out = dict(evals=[{k: round(v, 4) for k, v in e.items()} for e in evals])
    for k in evals[0]:
        out[f"{k}_mean"] = round(sum(e[k] for e in evals) / len(evals), 4)
    return out


def summarize(per_seed, *, recipe, train_arg, env, best_metric, total_steps, protocol,
              device, untrained_floor, side_by_side, curves, trained_env_steps) -> dict:
    """The study's artifact from its per-seed records (contiguous seeds):
    the JAX study's keys in its order, then the port's. ``note`` is the JAX
    study's (an extension's seed range), followed by TRUNCATED and the seeds
    whose ``trained_env_steps`` fall short of ``total_steps``."""
    seeds = [r["seed"] for r in per_seed]
    offset = seeds[0]
    if seeds != list(range(offset, offset + len(seeds))):
        raise ValueError(f"the study's seeds {seeds} are not contiguous")
    score_key = "arrival_rate" if best_metric == "arrivals" else "reward_per_step"
    means = [r[f"{score_key}_mean"] for r in per_seed]
    mu = sum(means) / len(means)
    sd = (sum((m - mu) ** 2 for m in means) / max(1, len(means) - 1)) ** 0.5
    notes = []
    if offset:
        notes.append("EXTENSION artifact: mean/std/floor cover ONLY this seed range — combine "
                     "per_seed with the base artifact before quoting study-level statistics")
    short = {s: n for s, n in trained_env_steps.items() if n < total_steps}
    if short:
        notes.append(f"TRUNCATED: seeds {sorted(map(int, short))} stopped at "
                     f"{min(short.values())}-{max(short.values())} of --total-steps "
                     f"{total_steps:g} env-steps; each scores the policy_best of its last "
                     "in-run eval")
    return dict(
        recipe=recipe,
        train_arg=train_arg,
        env=env,
        best_metric=best_metric,
        total_steps=total_steps,
        seeds=len(seeds),
        seed_offset=offset,
        seed_range=f"{offset}..{offset + len(seeds) - 1}",
        note=" ".join(notes) or None,
        per_seed=per_seed,
        score_key=score_key,
        mean=round(mu, 4),
        std=round(sd, 4),
        floor=round(min(means), 4),
        protocol=protocol,
        device=device,
        untrained_floor=untrained_floor,
        side_by_side=side_by_side,
        curves=curves,
        trained_env_steps=trained_env_steps,
    )


def combine(artifact_paths, side_by_side=None) -> dict:
    """One study's artifact from the artifacts of runs over disjoint seeds
    (e.g. one seed each, run side by side): their ``per_seed``,
    ``untrained_floor``, ``curves`` and ``trained_env_steps`` in seed
    order (so a truncated seed stays marked), the shared keys
    checked equal, the statistics recomputed by :func:`summarize`.
    ``side_by_side`` defaults to the number of artifacts."""
    arts = [json.loads(Path(p).read_text()) for p in artifact_paths]
    first = arts[0]
    for path, art in zip(artifact_paths, arts):
        for k in SHARED_KEYS:
            if art[k] != first[k]:
                raise ValueError(f"{path}: {k} {art[k]!r} differs from {first[k]!r}")
    order = sorted(range(len(arts)), key=lambda i: arts[i]["seed_offset"])
    devices = sorted({a["device"] for a in arts})
    return summarize(
        [r for i in order for r in arts[i]["per_seed"]],
        **{k: first[k] for k in SHARED_KEYS if k != "score_key"},
        device=devices[0] if len(devices) == 1 else "; ".join(devices),
        untrained_floor=[f for i in order for f in arts[i]["untrained_floor"]],
        side_by_side=len(arts) if side_by_side is None else side_by_side,
        curves={s: c for i in order for s, c in arts[i]["curves"].items()},
        trained_env_steps={s: n for i in order for s, n in arts[i]["trained_env_steps"].items()},
    )


def verdict(port_means, reference_means, floor, alpha=0.05) -> dict:
    """The study's rule against a reference: ``"fail"`` if the port's mean is
    below ``floor``; ``"suspect"`` if a one-sided Welch t-test rejects "port
    >= reference" at ``alpha``; else ``"pass"``. Returns the mean, Welch's t,
    its degrees of freedom (Welch-Satterthwaite), the one-sided p and the
    verdict."""
    from scipy import stats

    a, b = list(port_means), list(reference_means)
    va, vb = stats.tvar(a) / len(a), stats.tvar(b) / len(b)
    t = (sum(a) / len(a) - sum(b) / len(b)) / (va + vb) ** 0.5
    df = (va + vb) ** 2 / (va ** 2 / (len(a) - 1) + vb ** 2 / (len(b) - 1))
    p = float(stats.t.cdf(t, df))
    mean = sum(a) / len(a)
    return dict(mean=mean, t=float(t), df=float(df), p_one_sided=p,
                verdict="fail" if mean < floor else "suspect" if p < alpha else "pass")


def main(argv=None) -> dict:
    """Run the study; writes ``--artifact`` and returns its contents."""
    args = build_parser().parse_args(argv)
    if args.artifact is None:
        # an extension gets its own default, so it never overwrites the base study's
        suffix = f"_offset{args.seed_offset}" if args.seed_offset else ""
        args.artifact = f"runs/ppo_seed_study/summary{suffix}.json"
    from usv_tpu_torch.train import run_ppo

    results, floors, curves, trained = [], [], {}, {}
    for seed in range(args.seed_offset, args.seed_offset + args.seeds):
        logdir = f"{args.outdir}/seed{seed}"
        argv_seed = train_argv(args, seed, logdir)
        fresh = export_fresh_policy("ppo", argv_seed, Path(logdir) / "policy_init")
        floors.append(dict(seed=seed, **score(args, fresh)))
        print(json.dumps({"untrained_floor": floors[-1]}), flush=True)

        t0 = time.time()
        run_ppo.main(argv_seed)
        train_s = time.time() - t0
        bundle = Path(logdir, "policy_best")
        if not (bundle / "policy.json").exists():
            # a short run may end before the first in-run eval fires
            bundle = Path(logdir, "policy")
        rec = dict(seed=seed, train_seconds=round(train_s, 1), **score(args, bundle))
        results.append(rec)
        curves[str(seed)] = curve(logdir)
        trained[str(seed)] = curves[str(seed)][-1][0]
        print(json.dumps(rec), flush=True)
        print(json.dumps(dict(curve=seed, env_steps_and_reward=curves[str(seed)])), flush=True)

    summary = summarize(
        results, recipe=args.recipe, train_arg=args.train_arg, env=args.env,
        best_metric=args.best_metric, total_steps=args.total_steps,
        protocol=protocol(args.eval_episodes, args.eval_steps, args.eval_seeds),
        device=device_line(args.device), untrained_floor=floors, side_by_side=1, curves=curves,
        trained_env_steps=trained,
    )
    print(json.dumps({k: v for k, v in summary.items() if k != "curves"}), flush=True)
    Path(args.artifact).parent.mkdir(parents=True, exist_ok=True)
    Path(args.artifact).write_text(json.dumps(summary, indent=1) + "\n")
    print(f"wrote {args.artifact}", flush=True)
    from usv_tpu_torch.ops.raycast_cuda import counter

    # read by tools/side_by_side.py
    print(f"ray-cast kernel launches {counter.launches}", flush=True)
    return summary


if __name__ == "__main__":
    main()

"""Population/racing model selection shared by the robust train recipes —
port of ``usv_tpu/train/population.py``.

``--recipe robust`` (run_ppo/run_sac) trains S independent at-scale learners
as ONE batched program (the learners' ``*_many`` methods) and must end with
a defensible winner: this module re-evaluates every candidate's
best-snapshot parameters under shared fresh eval seeds through the learner's
own eval program (paired comparison — the same eval scenes for every
candidate), exports the winner with a replayable in-run-eval record plus the
full selection table, and returns the winner index. The reference's
counterpart workflow is N separate SB3 runs plus a human picking the best
(train_test/sb3_train_vec.py:58-81).

Against the JAX module: a candidate's parameters are a ``state_dict`` of one
member (``Stacked.member``) held on the host, the cull is the learner's
``take_members``, and the selection evals run under the seeds
``100_000 + es`` where JAX makes ``jax.random.key(100_000 + es)``; the
exported record names seed 100_000, so ``run_eval --replay-recorded-eval``
reruns the winner's first selection eval bit for bit.
"""

from __future__ import annotations

import time
import types

import numpy as np

from usv_tpu_torch.train.metrics import MetricLogger, score_eval_stats
from usv_tpu_torch.train.policy import export_policy, in_run_eval_meta

SELECT_SEED = 100_000  # the first selection eval's seed; the es-th is SELECT_SEED + es


def _to_host(params: dict) -> dict:
    return {k: v.detach().to("cpu") for k, v in params.items()}


def run_population_loop(learner, seeds, ts, args, *, train_many,
                        total_units, steps_per_unit, eval_every,
                        params_of):
    """The shared ``--recipe robust`` training loop (one body for the SAC and
    PPO CLIs): repeatedly step the population via ``train_many(ts) -> (ts,
    extra_metrics)``, snapshot each seed's best-eval parameters every
    ``eval_every`` units, optionally cull to the best seeds at
    ``--cull-at-frac`` (``learner.take_members``), then hand the candidates
    to :func:`select_and_export_winner`. ``params_of(ts)`` picks the
    exportable network from the population state: a ``Stacked`` (its
    ``member(i)`` is one seed's parameters). Returns the final population
    state (the JAX loop returns nothing; its state is donated)."""
    # Features of the single-seed loops that have no population analog yet
    # are surfaced, not silently dropped: a population run keeps its
    # best-snapshot state in host memory only.
    if getattr(args, "resume", False):
        raise SystemExit(
            "--resume is not supported with --population/--recipe robust: "
            "population runs keep no on-disk checkpoint to resume from"
        )
    # One unconditional info line (argparse cannot distinguish an
    # explicitly-passed default value, so a blanket notice is the only way
    # a user who typed `--checkpoint-every-iters 20` still learns it is
    # skipped), plus a per-flag warning only for values that differ from
    # the parser defaults the CLIs stash as _parser_defaults — a
    # default-valued flag the user never touched is not an opt-in worth a
    # louder warning on every robust run.
    print(
        "population mode: per-seed checkpoints/videos/param-watch are not "
        "supported and are skipped",
        flush=True,
    )
    defaults = getattr(args, "_parser_defaults", {})
    dropped = [
        f for f in ("checkpoint_every_iters", "checkpoint_every_blocks",
                    "video_every_iters", "video_every_blocks",
                    "watch_every_iters")
        if getattr(args, f, 0) and getattr(args, f, 0) != defaults.get(f, 0)
    ]
    if dropped:
        print(
            "population mode: explicitly requested "
            f"{', '.join('--' + f.replace('_', '-') for f in dropped)} "
            "will be ignored (pass 0 to silence)",
            flush=True,
        )

    logger = MetricLogger(args.logdir, config=vars(args))
    cull_keep = args.cull_keep or max(2, args.population // 2)
    cull_unit = (
        max(1, int(total_units * args.cull_at_frac))
        if args.cull_at_frac else 0
    )
    best = [dict(score=float("-inf"), params=None, stats=None) for _ in seeds]

    unit = 0
    t0 = time.time()
    while unit < total_units:
        ts, extra = train_many(ts)
        unit += 1
        sps = steps_per_unit * len(seeds) / max(1e-9, time.time() - t0)
        metrics = dict(
            env_steps_per_seed=unit * steps_per_unit,
            seeds_alive=len(seeds),
            aggregate_steps_per_second=sps,
            **extra,
        )
        if eval_every and unit % eval_every == 0:
            stats = learner.eval_policy_stats_many(
                ts, n_steps=args.eval_steps, num_envs=args.eval_envs
            )
            scores = []
            for i in range(len(seeds)):
                stats_i = {k: float(v[i]) for k, v in stats.items()}
                _, score = score_eval_stats(stats_i, args.best_metric)
                scores.append(float(score))
                if score > best[i]["score"]:
                    best[i] = dict(
                        score=float(score),
                        params=_to_host(params_of(ts).member(i)),
                        stats=stats_i,
                    )
            metrics.update(
                eval_scores=[round(s, 4) for s in scores],
                eval_best_so_far=[round(b["score"], 4) for b in best],
            )
        if (cull_unit and unit >= cull_unit and len(seeds) > cull_keep
                and any(np.isfinite(b["score"]) for b in best)):
            # racing: keep the best-so-far seeds
            order = np.argsort([-b["score"] for b in best])
            keep = sorted(int(i) for i in order[:cull_keep])
            metrics["culled_seeds"] = [
                seeds[i] for i in range(len(seeds)) if i not in keep
            ]
            seeds = [seeds[i] for i in keep]
            best = [best[i] for i in keep]
            ts = learner.take_members(ts, keep)
        logger.log(unit * steps_per_unit, **{
            k: v for k, v in metrics.items() if isinstance(v, (int, float))
        })
        print({k: (round(v, 3) if isinstance(v, float) else v)
               for k, v in metrics.items()}, flush=True)
        t0 = time.time()

    final = params_of(ts)
    candidates = []
    for i in range(len(seeds)):
        cand = best[i] if best[i]["params"] is not None else dict(
            score=float("-inf"),
            params=_to_host(final.member(i)),
        )
        candidates.append(cand)
    select_and_export_winner(
        learner, seeds, candidates, args,
        final_params_of_winner=lambda w: _to_host(final.member(w)),
    )
    logger.close()
    return ts


def select_and_export_winner(learner, seeds, candidates, args,
                             final_params_of_winner=None) -> int:
    """Population endgame; see module docstring.

    ``candidates[i]`` is ``{"score": in-run best, "params": state_dict}``;
    ``final_params_of_winner(i)`` (optional) supplies the winner's FINAL
    parameters for the standard ``<logdir>/policy`` export. Each candidate
    is evaluated as an ordinary module (``learner.module_from``) through
    ``learner.eval_policy_stats_at``: the program a bundle's replay reruns."""
    sel = []
    for i, cand in enumerate(candidates):
        module = learner.module_from(cand["params"])
        per_key = []
        for es in range(args.select_evals):
            st = learner.eval_policy_stats_at(
                module, SELECT_SEED + es,
                n_steps=args.eval_steps, num_envs=args.eval_envs,
            )
            _, sc = score_eval_stats(st, args.best_metric)
            per_key.append(dict(score=float(sc), stats=st))
        sel.append(dict(
            seed=int(seeds[i]),
            in_run_best=float(cand["score"]),
            select_scores=[p["score"] for p in per_key],
            select_mean=float(np.mean([p["score"] for p in per_key])),
            # full per-candidate eval stats averaged over the select seeds —
            # this puts collisions-at-selection next to arrivals in the
            # exported table
            select_stats_mean={
                k: float(np.mean([p["stats"][k] for p in per_key]))
                for k in per_key[0]["stats"]
            },
            first_eval=per_key[0],
        ))
    winner = int(np.argmax([s["select_mean"] for s in sel]))
    print({"population_selection": sel, "winner_seed": sel[winner]["seed"]},
          flush=True)

    first = sel[winner]["first_eval"]
    extra = in_run_eval_meta(
        args.env, args.best_metric, first["score"], first["stats"],
        SELECT_SEED, args.eval_steps, args.eval_envs,
    )
    extra["population"] = dict(
        recipe=args.recipe,
        seeds=[int(s) for s in seeds],
        winner_seed=sel[winner]["seed"],
        selection=[{k: v for k, v in s.items() if k != "first_eval"}
                   for s in sel],
    )
    best_module = learner.module_from(candidates[winner]["params"])
    export_policy(
        learner, types.SimpleNamespace(actor=best_module, model=best_module),
        f"{args.logdir}/policy_best", extra_meta=extra,
    )
    if final_params_of_winner is not None:
        final_module = learner.module_from(final_params_of_winner(winner))
        export_policy(
            learner, types.SimpleNamespace(actor=final_module, model=final_module),
            f"{args.logdir}/policy",
        )
    return winner

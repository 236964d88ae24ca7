"""PPO training CLI (config_ppo capability path) — port of
``usv_tpu/train/run_ppo.py``.

Usage:
    python -m usv_tpu_torch.train.run_ppo --env usv-simple --total-steps 1000000 [--device cpu]

    python -m usv_tpu_torch.train.run_ppo --recipe robust --env usv-asmc-ca-v0 \
        --total-steps 1000000 --cull-at-frac 0.5 --logdir runs/ppo_robust

Runs on the CUDA card unless ``--device`` names another device.
``--recipe robust`` or ``--population`` > 1 trains a seed population as one
batched program and exports the selected winner (``train/population.py``);
``--video-every-iters`` records an episode video of the current policy
(rendering needs pygame, and cv2 or imageio, on the host).
"""

from __future__ import annotations

import argparse
import time

# SB3-matching fallbacks for the recipe-tunable args (their argparse
# default is None so an explicit flag — even one repeating the fallback
# value — always beats the recipe).
_ARG_FALLBACKS = dict(
    num_envs=16, batch_size=64, update_fusion=1, eval_steps=500,
    lr_decay_updates=0, single_shuffle=False,
)
# families measured as update-granularity-sensitive (fusion hurts)
_GRANULARITY_SENSITIVE = ("usv-asmc-ca-v0",)


def apply_recipe(args, parser=None):
    """Resolve ``--recipe`` and the None-sentinel defaults into concrete
    args. Explicit flags always win over the recipe.

    ``at-scale``: 256 envs, minibatch 2048, one shuffle per iteration, and
    lr linearly annealed to 0 over the whole run (the decay horizon derived
    from total steps and the update geometry). The fusion depth is
    per-family: k4 on usv-simple-class tasks, k1 on the CA env, which is
    sensitive to update granularity.
    """
    if args.recipe in ("at-scale", "robust"):
        if args.num_envs is None:
            args.num_envs = 256
        if args.batch_size is None:
            args.batch_size = 2048
        if args.update_fusion is None:
            args.update_fusion = 1 if args.env in _GRANULARITY_SENSITIVE else 4
        if args.single_shuffle is None:
            args.single_shuffle = True
        if args.eval_steps is None:
            args.eval_steps = 1000
        if args.lr_decay_updates is None:
            from usv_tpu_torch.train.ppo import PpoConfig

            steps_per_iter = args.n_steps * args.num_envs
            # ceiling division: main()'s loop runs while it*steps_per_iter <
            # total_steps, a ceiling number of iterations
            iters = max(1, -(-int(args.total_steps) // steps_per_iter))
            opt_per_iter = PpoConfig().n_epochs * max(
                1, steps_per_iter // (args.batch_size * args.update_fusion))
            args.lr_decay_updates = iters * opt_per_iter
    if args.recipe == "robust" and args.population is None:
        args.population = 4
    if args.population is None:
        args.population = 1
    for name, fallback in _ARG_FALLBACKS.items():
        if getattr(args, name) is None:
            setattr(args, name, fallback)
    return args


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="usv-simple")
    p.add_argument("--recipe", choices=["none", "at-scale", "robust"], default="none",
                   help="named preset; 'at-scale' = 256 envs, batch 2048, 4-way update "
                        "fusion (1-way on usv-asmc-ca-v0), single shuffle, lr annealed over "
                        "the run (explicit flags override); 'robust' = the at-scale recipe "
                        "trained as a seed population in one batched program, winner "
                        "auto-selected by the shared eval protocol and exported")
    p.add_argument("--total-steps", type=float, default=10e6)
    p.add_argument("--num-envs", type=int, default=None)  # default 16
    p.add_argument("--n-steps", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=None)  # default 64
    p.add_argument("--update-fusion", type=int, default=None,  # default 1
                   help="fold k consecutive minibatches into one optimizer "
                        "step on a k*batch-size batch")
    p.add_argument("--single-shuffle", action=argparse.BooleanOptionalAction,
                   default=None,  # three-state: None = recipe may decide
                   help="one rollout permutation per iteration instead of per epoch; "
                        "--no-single-shuffle forces per-epoch reshuffling even under "
                        "--recipe at-scale")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--frame-stack", type=int, default=5)
    p.add_argument("--logdir", default="runs/ppo")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-every-iters", type=int, default=20)
    p.add_argument("--ignore-obstacles", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 MLP trunks (parameters and Adam state stay float32)")
    p.add_argument("--obs-bf16", action="store_true",
                   help="store rollout observations in bfloat16 for the update phase")
    p.add_argument("--shuffle-groups", type=int, default=0,
                   help="permute minibatch rows within N env-contiguous "
                        "groups instead of globally (stratified minibatches; 0 = global shuffle)")
    p.add_argument("--rotate-groups", action="store_true",
                   help="with --shuffle-groups: randomly permute the per-env state between "
                        "iterations so group membership rotates")
    p.add_argument("--video-every-iters", type=int, default=0,
                   help="record a policy episode video every N iterations")
    p.add_argument("--watch-every-iters", type=int, default=20,
                   help="log parameter-norm diagnostics every N iterations "
                        "(the reference's wandb.watch analog); 0 disables")
    p.add_argument("--eval-every-iters", type=int, default=10,
                   help="deterministic-policy eval every N iterations; the "
                        "best evaluation's policy is exported to "
                        "<logdir>/policy_best (0 disables)")
    p.add_argument("--lr-decay-updates", type=int, default=None,  # default 0
                   help="linear lr decay over this many gradient updates (0 = constant lr)")
    p.add_argument("--best-metric", choices=["reward", "arrivals"], default="reward",
                   help="metric that selects <logdir>/policy_best: eval reward/step, or "
                        "arrival rate on envs that report arrivals (falls back to reward)")
    p.add_argument("--eval-steps", type=int, default=None,  # default 500
                   help="deterministic-eval rollout length")
    p.add_argument("--eval-envs", type=int, default=16, help="deterministic-eval batch width")
    p.add_argument("--population", type=int, default=None,
                   help="train N seeds as one batched population and export the winner "
                        "(default 1; --recipe robust defaults 4)")
    p.add_argument("--cull-at-frac", type=float, default=0.0,
                   help="racing: at this fraction of the budget, keep only the --cull-keep "
                        "best-so-far seeds (0 disables)")
    p.add_argument("--cull-keep", type=int, default=None,
                   help="seeds surviving the cull (default population//2, min 2)")
    p.add_argument("--select-evals", type=int, default=3,
                   help="fresh-seed re-evals per candidate in the final winner selection "
                        "(population runs)")
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def ppo_config(args):
    """The ``PpoConfig`` a resolved argument namespace asks for."""
    from usv_tpu_torch.train.ppo import PpoConfig

    return PpoConfig(
        n_steps=args.n_steps,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        num_envs=args.num_envs,
        frame_stack=args.frame_stack,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        rollout_obs_bf16=args.obs_bf16,
        lr_decay_updates=args.lr_decay_updates or None,
        update_fusion=args.update_fusion,
        reshuffle_epochs=not args.single_shuffle,
        shuffle_groups=args.shuffle_groups,
        shuffle_group_rotate=args.rotate_groups,
    )


def run_population(args):
    """The ``--recipe robust`` path: S independent at-scale learners as one
    batched program, per-seed best-eval snapshots, optional racing cull, and
    winner selection by the shared eval protocol (the reference's
    counterpart is N separate SB3 runs plus a human picking the best,
    sb3_train_vec.py:58-81). Returns ``(learner, population state)``."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.population import run_population_loop
    from usv_tpu_torch.train.ppo import PpoLearner

    env_kwargs = {"ignore_obstacles": True} if args.ignore_obstacles else {}
    handle = make(args.env, device=args.device, **env_kwargs)
    learner = PpoLearner(handle, ppo_config(args))
    cfg = learner.cfg
    seeds = list(range(args.seed, args.seed + args.population))
    ts = learner.init_many(seeds)

    steps_per_iter = cfg.n_steps * cfg.num_envs  # per seed
    total_iters = max(1, -(-int(args.total_steps) // steps_per_iter))

    def train_many(ts):
        ts, rewards = learner.train_iteration_many(ts)
        return ts, dict(mean_reward=float(rewards.mean()))

    ts = run_population_loop(
        learner, seeds, ts, args,
        train_many=train_many,
        total_units=total_iters,
        steps_per_unit=steps_per_iter,
        eval_every=args.eval_every_iters,
        params_of=lambda ts: ts.model,
    )
    return learner, ts


def main(argv=None):
    """Train; returns ``(learner, train_state)`` of the finished run (a
    population state for ``--population`` > 1)."""
    p = build_parser()
    args = apply_recipe(p.parse_args(argv), p)
    if args.rotate_groups and args.shuffle_groups <= 1:
        # fail fast: the rotation is gated on the grouped shuffle and would
        # otherwise be a silent no-op
        p.error("--rotate-groups requires --shuffle-groups > 1 (rotation permutes group "
                "MEMBERSHIP of the grouped shuffle; with the global shuffle there is "
                "nothing to rotate)")
    # population.py warns about flags it must ignore only when they differ
    # from these parser defaults (i.e. the user actually set them)
    args._parser_defaults = {f: p.get_default(f) for f in vars(args)}
    if args.population > 1:
        return run_population(args)

    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.checkpoint import save_checkpoint
    from usv_tpu_torch.train.metrics import MetricLogger, score_eval_stats
    from usv_tpu_torch.train.policy import export_policy, in_run_eval_meta
    from usv_tpu_torch.train.ppo import PpoLearner

    env_kwargs = {"ignore_obstacles": True} if args.ignore_obstacles else {}
    handle = make(args.env, device=args.device, **env_kwargs)
    cfg = ppo_config(args)
    learner = PpoLearner(handle, cfg)
    ts = learner.init(seed=args.seed)
    logger = MetricLogger(args.logdir, config=vars(args))

    steps_per_iter = cfg.n_steps * cfg.num_envs
    it = 0
    best_eval = float("-inf")
    t0 = time.time()
    while it * steps_per_iter < args.total_steps:
        ts, mean_reward = learner.train_iteration(ts)
        it += 1
        mean_reward = float(mean_reward)  # waits for the device: time the real work
        sps = steps_per_iter / max(1e-9, time.time() - t0)
        metrics = dict(env_steps=it * steps_per_iter, mean_reward=mean_reward,
                       steps_per_second=sps)
        if args.watch_every_iters and it % args.watch_every_iters == 0:
            metrics.update(learner.watch(ts))
        if args.eval_every_iters and it % args.eval_every_iters == 0:
            stats = learner.eval_policy_stats(ts, n_steps=args.eval_steps, num_envs=args.eval_envs)
            eval_metrics, score = score_eval_stats(stats, args.best_metric)
            metrics.update(eval_metrics)
            if score > best_eval:
                best_eval = score
                export_policy(learner, ts, f"{args.logdir}/policy_best", extra_meta=in_run_eval_meta(
                    args.env, args.best_metric, score, stats, learner.eval_seed(ts),
                    args.eval_steps, args.eval_envs))
        if args.video_every_iters and it % args.video_every_iters == 0:
            import torch

            from usv_tpu_torch.utils.video import record_rollout_video

            model = ts.model

            def vid_policy(obs):
                return torch.clamp(model.pi_mean(model.pi_trunk(obs)), learner._low, learner._high)

            _, vid_reward = record_rollout_video(
                handle, vid_policy, f"{args.logdir}/videos/step_{it * steps_per_iter}",
                n_steps=500, seed=it, frame_stack=cfg.frame_stack,
            )
            metrics["video_episode_reward"] = vid_reward
        logger.log(it * steps_per_iter, **metrics)
        print({k: round(v, 3) if isinstance(v, float) else v for k, v in metrics.items()}, flush=True)
        if args.checkpoint_every_iters and it % args.checkpoint_every_iters == 0:
            save_checkpoint(f"{args.logdir}/ckpt", ts, it * steps_per_iter)
        t0 = time.time()  # exclude eval/checkpoint from the next iter's rate
    save_checkpoint(f"{args.logdir}/ckpt", ts, it * steps_per_iter)
    export_policy(learner, ts, f"{args.logdir}/policy")
    logger.close()
    return learner, ts


if __name__ == "__main__":
    main()

"""SAC training CLI — port of ``usv_tpu/train/run_sac.py``.

Usage:
    python -m usv_tpu_torch.train.run_sac --env usv-simple --total-steps 1000000 \\
        --num-envs 256 --logdir runs/sac [--device cpu]

    python -m usv_tpu_torch.train.run_sac --recipe robust --env usv-simple \
        --total-steps 1000000 --cull-at-frac 0.5 --logdir runs/sac_robust

Env batch, replay and learner live on the device (the CUDA card unless
``--device`` names another); the host loop runs blocks of rounds and logs
metrics, evals, the best policy, checkpoints and, with
``--video-every-blocks``, an episode video of the current policy (rendering
needs pygame, and cv2 or imageio, on the host). ``--recipe robust`` or
``--population`` > 1 trains a seed population as one batched program and
exports the selected winner (``train/population.py``).

``--shard`` (and ``--shard-local-replay``, per-shard replay insert and
sample) trains one run data-parallel over the ranks of a launcher:

    torchrun --nproc-per-node=<gpus> -m usv_tpu_torch.train.run_sac \
        --recipe at-scale --shard --shard-local-replay

Each rank steps its share of the envs on its own card (NCCL), the learner is
replicated and its gradients summed over the ranks; rank 0 alone writes the
logdir. Without a launcher the mesh is one shard in this process.
"""

from __future__ import annotations

import argparse
import time

# SB3-matching fallbacks for the recipe-tunable args (argparse default None
# so an explicit flag — even one repeating the fallback — beats the recipe)
_ARG_FALLBACKS = dict(
    num_envs=256, train_freq=8, gradient_steps=8, update_fusion=1, lr=1e-4,
    buffer_size=400_000,
)


def apply_recipe(args):
    """Resolve ``--recipe`` + None-sentinels. Explicit flags always win.

    ``at-scale``: the wide-batch recipe — 1024 envs, 64 env steps / 64
    gradient steps per round with 4-way update fusion (16 sequential updates
    of batch 1024), lr 3e-4. ``robust``: the at-scale recipe trained as a
    seed population (default 4, buffer 100k per seed)."""
    if args.recipe in ("at-scale", "robust"):
        if args.num_envs is None:
            args.num_envs = 1024
        if args.train_freq is None:
            args.train_freq = 64
        if args.gradient_steps is None:
            args.gradient_steps = 64
        if args.update_fusion is None:
            args.update_fusion = 4
        if args.lr is None:
            args.lr = 3e-4
    if args.recipe == "robust":
        if args.population is None:
            args.population = 4
        if args.buffer_size is None:
            args.buffer_size = 100_000
    if args.population is None:
        args.population = 1
    for name, fallback in _ARG_FALLBACKS.items():
        if getattr(args, name) is None:
            setattr(args, name, fallback)
    return args


def sac_config(args):
    """The ``SacConfig`` a resolved argument namespace asks for."""
    from usv_tpu_torch.train.sac import SacConfig

    return SacConfig(
        buffer_size=args.buffer_size,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        lr_decay_steps=args.lr_decay_steps or None,
        lr_final_fraction=args.lr_final_frac,
        learning_starts=args.learning_starts,
        train_freq=args.train_freq,
        gradient_steps=args.gradient_steps,
        use_sde=args.sde,
        num_envs=args.num_envs,
        frame_stack=args.frame_stack,
        lambda_t=args.lambda_t,
        lambda_s=args.lambda_s,
        eps_s=args.eps_s,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        fused_updates=args.fused_updates,
        update_fusion=args.update_fusion,
        shard_local_replay=args.shard_local_replay,
    )


def run_sac_population(args):
    """The SAC ``--recipe robust`` path: S independent at-scale learners
    (envs, replay buffers, networks) as one batched program, per-seed
    best-eval snapshots, optional racing cull, and winner selection by the
    shared eval protocol (``train/population.py``). Per-seed budget =
    ``--total-steps``. Returns ``(learner, population state)``."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.population import run_population_loop
    from usv_tpu_torch.train.sac import SacLearner

    env_kwargs = {"ignore_obstacles": True} if args.ignore_obstacles else {}
    handle = make(args.env, device=args.device, **env_kwargs)
    learner = SacLearner(handle, sac_config(args))
    cfg = learner.cfg
    seeds = list(range(args.seed, args.seed + args.population))
    ts = learner.init_many(seeds)
    print(f"population replay: {len(seeds)} seeds x {learner.buffer_capacity} rows, "
          f"{ts.buffer.nbytes()} bytes on {ts.buffer.obs.device}", flush=True)

    steps_per_block = args.rounds_per_block * cfg.train_freq * cfg.num_envs
    total_blocks = max(1, -(-int(args.total_steps) // steps_per_block))

    def train_many(ts):
        ts, reward_sum = learner.train_rounds_many(ts, args.rounds_per_block)
        per_step = float(reward_sum.mean()) / steps_per_block
        return ts, dict(collect_reward_per_step=per_step)

    ts = run_population_loop(
        learner, seeds, ts, args,
        train_many=train_many,
        total_units=total_blocks,
        steps_per_unit=steps_per_block,
        eval_every=args.eval_every_blocks,
        params_of=lambda ts: ts.actor,
    )
    return learner, ts


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="usv-simple")
    p.add_argument("--recipe", choices=["none", "at-scale", "robust"], default="none",
                   help="named preset; 'at-scale' = 1024 envs, g64 k4 (16 seq updates of "
                        "batch 1024 per round), lr 3e-4; 'robust' = at-scale trained as a seed "
                        "population in one batched program (default 4, 100k buffer/seed), "
                        "winner auto-selected and exported; explicit flags override")
    p.add_argument("--total-steps", type=float, default=10e6)  # sb3_train.py:13
    p.add_argument("--num-envs", type=int, default=None)       # default 256
    p.add_argument("--buffer-size", type=int, default=None)    # default 400k
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--learning-starts", type=int, default=50_000)
    p.add_argument("--lr", type=float, default=None)           # default 1e-4
    p.add_argument("--lr-decay-steps", type=int, default=0,
                   help="linear lr decay over this many gradient steps "
                        "(0 = constant, the reference behavior)")
    p.add_argument("--lr-final-frac", type=float, default=0.1)
    p.add_argument("--train-freq", type=int, default=None)      # default 8
    p.add_argument("--gradient-steps", type=int, default=None)  # default 8
    p.add_argument("--sde", default=True, action=argparse.BooleanOptionalAction,
                   help="gSDE exploration (reference config_sac default; "
                        "--no-sde for per-step Gaussian noise)")
    p.add_argument("--frame-stack", type=int, default=5)
    p.add_argument("--lambda-t", type=float, default=10.0)
    p.add_argument("--lambda-s", type=float, default=5.0)
    p.add_argument("--eps-s", type=float, default=0.1)
    p.add_argument("--rounds-per-block", type=int, default=200)
    p.add_argument("--logdir", default="runs/sac")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-every-blocks", type=int, default=10)
    p.add_argument("--eval-every-blocks", type=int, default=5)
    p.add_argument("--best-metric", choices=["reward", "arrivals"], default="reward",
                   help="metric that selects <logdir>/policy_best: eval reward/step, or "
                        "arrival rate on envs that report arrivals (falls back to reward)")
    p.add_argument("--eval-steps", type=int, default=500,
                   help="deterministic-eval rollout length")
    p.add_argument("--eval-envs", type=int, default=16, help="deterministic-eval batch width")
    p.add_argument("--ignore-obstacles", action="store_true")
    p.add_argument("--shard", action="store_true",
                   help="shard env batch + replay over the ranks of the launcher "
                        "(torchrun); the learner is replicated, its gradients summed")
    p.add_argument("--shard-local-replay", action="store_true",
                   help="with --shard: per-shard replay insert/sample, so that the only "
                        "steady-state collectives are the gradient sums")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 MLP trunks (parameters and Adam state stay float32)")
    p.add_argument("--fused-updates", action="store_true",
                   help="one gradient_steps*batch update per round instead "
                        "of gradient_steps sequential updates")
    p.add_argument("--update-fusion", type=int, default=None,  # default 1
                   help="fold k sequential updates into one k*batch update "
                        "(k must divide gradient-steps)")
    p.add_argument("--light-checkpoints", action="store_true",
                   help="exclude the replay buffer from checkpoints (much "
                        "faster saves; resume re-warms an empty buffer)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint from <logdir>/ckpt before training")
    p.add_argument("--video-every-blocks", type=int, default=0,
                   help="record a policy episode video every N blocks (device-side "
                        "rollout, host-side rendering)")
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


def main(argv=None):
    """Train; returns ``(learner, train_state)`` of the finished run (a
    population state for ``--population`` > 1)."""
    p = build_parser()
    args = apply_recipe(p.parse_args(argv))
    # population.py warns about flags it must ignore only when they differ
    # from these parser defaults (i.e. the user actually set them)
    args._parser_defaults = {f: p.get_default(f) for f in vars(args)}
    if args.population > 1:
        if args.shard or args.shard_local_replay:
            p.error("--population is incompatible with --shard (a population already "
                    "fills the chip; the data-parallel layer shards single-seed runs)")
        return run_sac_population(args)
    if not (args.shard or args.shard_local_replay):
        return train(args)
    import torch.distributed as dist

    from usv_tpu_torch.parallel.dist import initialize_distributed, shutdown_distributed

    # from the launcher's environment, unless the caller brought a group up
    created = not dist.is_initialized() and initialize_distributed(device=args.device)
    try:
        return train(args, sharded=True)
    finally:
        if created:
            shutdown_distributed()


def train(args, sharded: bool = False):
    """The single-seed run of a resolved argument namespace; with
    ``sharded``, over the mesh of the process group (or a one-shard mesh).
    Returns ``(learner, train_state)``."""
    import torch.distributed as dist

    from usv_tpu_torch.envs import make
    from usv_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from usv_tpu_torch.train.metrics import MetricLogger, score_eval_stats
    from usv_tpu_torch.train.policy import export_policy, in_run_eval_meta
    from usv_tpu_torch.train.sac import SacLearner

    mesh, device = None, args.device
    if sharded:
        from usv_tpu_torch.parallel.dist import rank_device
        from usv_tpu_torch.parallel.mesh import make_env_mesh

        if dist.is_initialized():
            device = rank_device()
        mesh = make_env_mesh(device=device)
    writer = mesh is None or mesh.logical or mesh.rank == 0  # rank 0 alone writes the logdir
    env_kwargs = {"ignore_obstacles": True} if args.ignore_obstacles else {}
    handle = make(args.env, device=device, **env_kwargs)
    cfg = sac_config(args)
    learner = SacLearner(handle, cfg, mesh=mesh)
    ts = learner.init(seed=args.seed)

    if args.resume:
        # a light checkpoint leaves the fresh, empty buffer of ``ts`` in place
        ts, at_step = restore_checkpoint(f"{args.logdir}/ckpt", ts)
        if writer:
            print(f"resumed from checkpoint at env step {at_step}", flush=True)
    if mesh is not None:
        from usv_tpu_torch.parallel.sharded import shard_sac_train_state

        ts = shard_sac_train_state(ts, mesh)
        if writer:
            print(f"sharded over {mesh}: {cfg.num_envs // mesh.size} envs and "
                  f"{ts.buffer.capacity} replay rows a rank", flush=True)

    logger = MetricLogger(args.logdir, config=vars(args)) if writer else None
    steps_per_block = args.rounds_per_block * cfg.train_freq * cfg.num_envs
    block = 0
    best_eval = float("-inf")
    t0 = time.time()
    while ts.env_steps * cfg.num_envs < args.total_steps:
        ts, reward_sum = learner.train_rounds(ts, args.rounds_per_block)
        block += 1
        reward = float(reward_sum)  # waits for the device: time the real work
        sps = steps_per_block / max(1e-9, time.time() - t0)
        env_steps = ts.env_steps * cfg.num_envs
        metrics = dict(
            env_steps=env_steps,
            grad_steps=ts.grad_steps,
            collect_reward_per_step=reward / steps_per_block,
            steps_per_second=sps,
        )
        if args.eval_every_blocks and block % args.eval_every_blocks == 0:
            stats = learner.eval_policy_stats(ts, n_steps=args.eval_steps, num_envs=args.eval_envs)
            eval_metrics, score = score_eval_stats(stats, args.best_metric)
            metrics.update(eval_metrics)
            if score > best_eval:
                best_eval = score
                if writer:
                    export_policy(learner, ts, f"{args.logdir}/policy_best",
                                  extra_meta=in_run_eval_meta(
                                      args.env, args.best_metric, score, stats,
                                      learner.eval_seed(ts), args.eval_steps, args.eval_envs))
            if ts.buffer.size > 0:  # wandb.watch analog (needs data)
                metrics.update(learner.watch(ts))
        if writer and args.video_every_blocks and block % args.video_every_blocks == 0:
            from usv_tpu_torch.utils.video import record_rollout_video

            _, vid_reward = record_rollout_video(
                handle, ts.actor.deterministic, f"{args.logdir}/videos/step_{env_steps}",
                n_steps=500, seed=block, frame_stack=cfg.frame_stack,
            )
            metrics["video_episode_reward"] = vid_reward
        if writer:
            logger.log(env_steps, **metrics)
            print({k: round(v, 3) if isinstance(v, float) else v for k, v in metrics.items()},
                  flush=True)
        if args.checkpoint_every_blocks and block % args.checkpoint_every_blocks == 0:
            save_checkpoint(f"{args.logdir}/ckpt", ts, env_steps,
                            include_buffer=not args.light_checkpoints)
        t0 = time.time()  # exclude eval/checkpoint from the next block's rate
    save_checkpoint(f"{args.logdir}/ckpt", ts, ts.env_steps * cfg.num_envs,
                    include_buffer=not args.light_checkpoints)
    if writer:
        export_policy(learner, ts, f"{args.logdir}/policy")
        logger.close()
    return learner, ts


if __name__ == "__main__":
    main()

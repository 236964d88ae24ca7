"""Run the PPO seed study's seeds side by side on one device.

Starts one ``study_ppo_k4_seeds`` process per seed (``--seeds 1
--seed-offset k``, each with its own ``--outdir`` and ``--artifact``, one
CPU thread each), all at once, so that each dispatches from its own host
core while the card, idle most of a host-bound step, serves them in turn.
When they have all finished it combines their artifacts into one with
``study_ppo_k4_seeds.combine`` and writes a report beside it: the host's
cores and load, each process's wall seconds, seconds per iteration
(from its ``metrics.jsonl``: env-steps of an iteration over its
``steps_per_second``), steady seconds per iteration (the median of all
but the first), kernel launches, and the aggregate env-steps/s.

    python -m usv_tpu_torch.tools.side_by_side --first-seed 0 --processes 5 \\
        --outdir runs/ppo_study --artifact runs/ppo_study/study.json \\
        -- --total-steps 1e8 --env usv-simple --best-metric reward --eval-steps 1000

The flags after ``--`` go to every study process. On the card the kernel is
built once here before the processes start, so that none of them runs
``nvcc``. A run that may not fit the time it has takes ``--stop-at``: the
processes still running that many seconds after the launch are stopped (at a
moment when no export of their ``policy_best`` is half written), and each of
their seeds is scored on its last in-run eval's ``policy_best`` as
it stands (its ``trained_env_steps`` say how far it got, and the artifact's
``note`` says TRUNCATED).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

from usv_tpu_torch.tools import study_ppo_k4_seeds as study
from usv_tpu_torch.tools.study_robust_band import curve, device_line

LAUNCHES = re.compile(r"^ray-cast kernel launches (\d+)$", re.M)
POLL_SECONDS = 2.0


def iteration_seconds(logdir) -> list:
    """Seconds of each logged iteration: its env-steps over its rate."""
    recs = [json.loads(x) for x in Path(logdir, "metrics.jsonl").read_text().splitlines() if x.strip()]
    steps = [r["env_steps"] for r in recs]
    per_iter = [b - a for a, b in zip([0] + steps, steps)]
    return [n / r["steps_per_second"] for n, r in zip(per_iter, recs)]


def whole_bundle(bundle) -> bool:
    """Whether both files of ``bundle`` are whole and were written together.
    ``export_policy`` writes ``policy.json`` and then ``params.pt``, so a
    process stopped between the two, or inside either, leaves a
    ``policy.json`` that does not parse, a ``params.pt`` that does not load,
    or a ``params.pt`` older than its ``policy.json``."""
    import torch

    meta, params = Path(bundle, "policy.json"), Path(bundle, "params.pt")
    try:
        json.loads(meta.read_text())
        torch.load(params, map_location="cpu")
    except Exception:
        return False
    return params.stat().st_mtime_ns >= meta.stat().st_mtime_ns


def stop_between_exports(proc, bundle) -> None:
    """Kill ``proc`` at a moment when ``bundle`` is whole: freeze it, look,
    and let it run on for a tenth of a second while an export is half
    written (ten seconds at most: a bundle that never became whole is
    refused by :func:`truncated_artifact`)."""
    for _ in range(100):
        proc.send_signal(signal.SIGSTOP)
        if whole_bundle(bundle):
            break
        proc.send_signal(signal.SIGCONT)
        time.sleep(0.1)
    proc.kill()
    proc.wait()


def truncated_artifact(seed, outdir, study_flags, device) -> dict:
    """The single-seed artifact of a study process stopped before its end:
    its last in-run eval's ``policy_best`` scored here by the study's
    protocol, the untrained floor its log printed, the iterations it
    logged and the env-steps it trained. Written where the process would
    have written its own."""
    args = study.build_parser().parse_args(
        list(study_flags) + ([] if device is None else ["--device", device]))
    logdir = outdir / f"p{seed}" / f"seed{seed}"
    floor = [json.loads(x)["untrained_floor"] for x in (outdir / f"seed{seed}.log").read_text().splitlines()
             if x.startswith('{"untrained_floor"')][0]
    last = json.loads((logdir / "metrics.jsonl").read_text().splitlines()[-1])
    if not whole_bundle(logdir / "policy_best"):
        raise RuntimeError(f"seed {seed}: no whole policy_best bundle to score")
    rec = dict(seed=seed, train_seconds=round(last["wall_s"], 1),
               **study.score(args, logdir / "policy_best"))
    art = study.summarize(
        [rec], recipe=args.recipe, train_arg=args.train_arg, env=args.env,
        best_metric=args.best_metric, total_steps=args.total_steps,
        protocol=study.protocol(args.eval_episodes, args.eval_steps, args.eval_seeds),
        device=device_line(args.device), untrained_floor=[floor], side_by_side=1,
        curves={str(seed): curve(logdir)}, trained_env_steps={str(seed): last["env_steps"]})
    (outdir / f"seed{seed}.json").write_text(json.dumps(art, indent=1) + "\n")
    return art


def launch(first_seed, processes, outdir, study_flags, device=None, stop_at=None) -> dict:
    """Run seeds ``first_seed .. first_seed + processes - 1`` in as many
    concurrent study processes; returns the report (the combined artifact
    under ``"artifact"``). A process that fails fails the launch, and every
    process is stopped first. With ``stop_at``, the processes still running
    that many seconds after the launch are stopped and their seeds scored as
    they stand (:func:`truncated_artifact`)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    on_card = (device or "cuda") != "cpu"
    if on_card:
        from usv_tpu_torch import _build

        _build.build()  # every kernel once, before the processes load them
    device_flag = [] if device is None else ["--device", device]
    root = str(Path(__file__).resolve().parents[2])  # the checkout holding usv_tpu_torch
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    seeds = list(range(first_seed, first_seed + processes))
    load_before = Path("/proc/loadavg").read_text().split()[:3]
    procs, logs = {}, {}
    t0 = time.time()
    for seed in seeds:
        logs[seed] = open(outdir / f"seed{seed}.log", "w")
        procs[seed] = subprocess.Popen(
            [sys.executable, "-m", "usv_tpu_torch.tools.study_ppo_k4_seeds", "--seeds", "1",
             "--seed-offset", str(seed), "--outdir", str(outdir / f"p{seed}"),
             "--artifact", str(outdir / f"seed{seed}.json")] + device_flag + list(study_flags),
            stdout=logs[seed], stderr=subprocess.STDOUT, env=env)
    walls, failed, stopped = {}, [], []
    try:
        while len(walls) < len(procs):
            now = time.time() - t0
            for seed, proc in procs.items():
                if seed not in walls and proc.poll() is not None:
                    walls[seed] = now
                    if proc.returncode != 0:
                        failed.append(seed)
            if failed:
                break
            if stop_at is not None and now > stop_at:
                stopped = [s for s in seeds if s not in walls]
                walls.update({s: now for s in stopped})
                for s in stopped:
                    stop_between_exports(procs[s], outdir / f"p{s}" / f"seed{s}" / "policy_best")
                break
            time.sleep(POLL_SECONDS)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()
    load_after = Path("/proc/loadavg").read_text().split()[:3]
    if failed:
        tails = {s: (outdir / f"seed{s}.log").read_text()[-3000:] for s in failed}
        raise RuntimeError(f"study processes of seeds {failed} failed: {tails}")

    for seed in stopped:
        truncated_artifact(seed, outdir, study_flags, device)
    artifact = study.combine([outdir / f"seed{s}.json" for s in seeds], side_by_side=processes)
    per_seed = {}
    for seed, rec in zip(seeds, artifact["per_seed"]):
        secs = iteration_seconds(outdir / f"p{seed}" / f"seed{seed}")
        found = LAUNCHES.findall((outdir / f"seed{seed}.log").read_text())
        per_seed[seed] = dict(
            wall_seconds=walls[seed], train_seconds=rec["train_seconds"], iteration_seconds=secs,
            steady_iteration_seconds=statistics.median(secs[1:]) if len(secs) > 1 else secs[0],
            launches=int(found[-1]) if found else None,
        )
    iter_steps = artifact["curves"][str(seeds[0])][0][0]
    env_steps = sum(artifact["trained_env_steps"].values())
    return dict(
        processes=processes, seeds=seeds, cpu_count=os.cpu_count(),
        loadavg_before=load_before, loadavg_after=load_after, device=artifact["device"],
        stopped=stopped,
        wall_seconds=max(walls.values()), per_seed=per_seed,
        aggregate_steady_env_steps_per_s=sum(iter_steps / r["steady_iteration_seconds"]
                                             for r in per_seed.values()),
        aggregate_env_steps_per_s_over_wall=env_steps / max(walls.values()),
        artifact=artifact,
    )


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    study_flags = argv[argv.index("--") + 1:] if "--" in argv else []
    own = argv[:argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser()
    p.add_argument("--first-seed", type=int, default=0)
    p.add_argument("--processes", type=int, required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--artifact", required=True, help="the combined study artifact")
    p.add_argument("--stop-at", type=float, default=None,
                   help="stop the processes still running after this many seconds and score "
                        "their seeds' policy_best as they stand")
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    args = p.parse_args(own)
    report = launch(args.first_seed, args.processes, args.outdir, study_flags,
                    device=args.device, stop_at=args.stop_at)
    art = report.pop("artifact")
    Path(args.artifact).parent.mkdir(parents=True, exist_ok=True)
    Path(args.artifact).write_text(json.dumps(art, indent=1) + "\n")
    report_path = Path(args.artifact).with_name(Path(args.artifact).stem + "_side_by_side.json")
    report_path.write_text(json.dumps(report, indent=1) + "\n")
    print(json.dumps(report), flush=True)
    print(f"wrote {args.artifact} ({art['score_key']} mean {art['mean']} ± {art['std']} floor "
          f"{art['floor']}) and {report_path}", flush=True)
    return dict(report, artifact=art)


if __name__ == "__main__":
    main()

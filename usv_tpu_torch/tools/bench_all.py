"""Throughput of every env family — port of ``tools/bench_all.py``.

Every registered id through :func:`usv_tpu_torch.vector.throughput` (zero
actions, auto-reset, the obs carried and the reward and done summed on the
device every step; one warm-up run, then the best of 3, each ended by a
device synchronize), all in one process. Prints one JSON line per family and
a closing summary with the JAX script's keys plus ``device`` (the card's
name and power limit as nvidia-smi gives them, or ``"cpu"``).

Usage (on the card unless ``--device`` names another)::

    python -m usv_tpu_torch.tools.bench_all [--envs 4096] [--steps 2048] \\
        [--families usv-simple ...] [--out FILE | --round N] [--device cpu]

``--round N`` writes ``docs/artifacts/torch_bench_families_r<NN>.json`` (the
JAX package's ``bench_families_r<NN>.json`` are TPU records and stay its
own); ``--out`` writes any path. A written artifact also holds
``recorded_unix``, ``host`` and ``git``.
"""

from __future__ import annotations

import argparse
import json
import platform
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
ARTIFACTS = REPO / "docs" / "artifacts"
PROTOCOL = ("vector.throughput: rollout of zero actions with auto-reset, obs carried and "
            "reward/done summed on the device every step, best of 3 after a warm-up, "
            "one process")
# the keys of a family line, of the printed summary and of a written artifact
FAMILY_KEYS = ("env", "ms_per_step", "steps_per_second")
SUMMARY_KEYS = ("num_envs", "steps", "protocol", "families", "device")
ARTIFACT_KEYS = SUMMARY_KEYS + ("recorded_unix", "host", "git")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=2048)
    p.add_argument("--families", nargs="*", default=None)
    p.add_argument("--out", default=None, help="write the sweep as a JSON artifact to this path")
    p.add_argument("--round", type=int, default=None,
                   help="shorthand: write docs/artifacts/torch_bench_families_r<NN>.json")
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def git_revision():
    """The checkout's short revision, or ``None`` outside a git checkout."""
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                             text=True, check=True, cwd=REPO)
    except (OSError, subprocess.CalledProcessError):
        return None
    return rev.stdout.strip() or None


def main(argv=None) -> dict:
    """Run the sweep; returns the summary (the artifact's contents when one
    is written)."""
    args = build_parser().parse_args(argv)
    from usv_tpu_torch.envs import make, registered_ids
    from usv_tpu_torch.envs.registry import resolve_device
    from usv_tpu_torch.tools.study_robust_band import device_line
    from usv_tpu_torch.vector import throughput

    device = resolve_device(args.device)
    out_path = args.out
    if out_path is None and args.round is not None:
        out_path = str(ARTIFACTS / f"torch_bench_families_r{args.round:02d}.json")

    results = []
    for env_id in args.families or registered_ids():
        out = throughput(make(env_id, device=device), num_envs=args.envs, n_steps=args.steps,
                         repeats=3)
        rec = dict(env=env_id,
                   ms_per_step=round(1e3 * args.envs / out["steps_per_second"], 3),
                   steps_per_second=round(out["steps_per_second"]))
        results.append(rec)
        print(json.dumps(rec), flush=True)

    summary = {"num_envs": args.envs, "steps": args.steps, "protocol": PROTOCOL,
               "families": results, "device": device_line(device)}
    print(json.dumps(summary), flush=True)
    if out_path:
        summary["recorded_unix"] = int(time.time())
        summary["host"] = platform.node()
        rev = git_revision()
        if rev is not None:  # omit provenance rather than record an empty string
            summary["git"] = rev
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(summary, indent=1) + "\n")
        print(f"wrote {out_path}", flush=True)
    return summary


if __name__ == "__main__":
    main()

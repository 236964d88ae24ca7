"""Single-env throughput on the reference's own protocol — port of
``tools/reference_protocol_bench.py``.

The reference's only throughput protocol is one env, a Python loop, 10k
zero-action steps (its ``tools/profile_env.py``). Sides, one measurement a
process, each record added to ``docs/artifacts/torch_single_env_protocol_h100.json``
under JAX's name with the device in place of the platform, and with
``device`` (nvidia-smi's name and power limit, or ``"cpu"``):

  compat     ``compat.UsvSimpleEnv`` stepped by the host loop: the per-step
             dispatch an SB3/DummyVecEnv user pays (``compat_<device>_loop``)
  core       ``vector.throughput`` at batch 1 (``core_scan_<device>_b1``)
  crossover  aggregate env-steps/s against the batch size, a host loop of
             ``BatchedEnv.step`` calls beside ``vector.throughput``
             (``crossover_<device>``)

JAX's "scan" is one compiled ``lax.scan`` program; the port's counterpart,
in ``core`` and in the crossover's ``scan_aggregate_steps_per_second``, is
``throughput``'s loop, an eager loop on the device that reads nothing back
until it ends, where the host loop reads the reward back every step. The
``ref`` side (the reference's own ``UsvSimpleEnv``) needs the reference's
checkout and is not ported.

Usage (on the card unless ``--device cpu``)::

    python -m usv_tpu_torch.tools.reference_protocol_bench --side compat
    python -m usv_tpu_torch.tools.reference_protocol_bench --side core --device cpu
    python -m usv_tpu_torch.tools.reference_protocol_bench --side crossover \\
        [--batches 1 4 16 64 256 1024] [--steps 10000]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
ARTIFACT = REPO / "docs" / "artifacts" / "torch_single_env_protocol_h100.json"
# the keys of a loop side's record (compat, core), of the crossover's and of its rows
LOOP_KEYS = ("steps_per_second", "seconds", "steps", "note", "device")
CROSSOVER_KEYS = ("rows", "note", "device")
CROSSOVER_ROW_KEYS = ("batch", "loop_aggregate_steps_per_second", "scan_aggregate_steps_per_second")
SCAN_NOTE = ("the scan column is vector.throughput's loop: eager on the device, nothing read "
             "back until the run ends (JAX: one lax.scan program)")


def _record(entry, device):
    """Add ``entry`` (under its ``name``, with the device line) to the
    artifact; prints and returns it."""
    from usv_tpu_torch.tools.study_robust_band import device_line

    entry = dict(entry, device=device_line(device))
    data = json.loads(ARTIFACT.read_text()) if ARTIFACT.exists() else {}
    data[entry.pop("name")] = entry
    ARTIFACT.parent.mkdir(parents=True, exist_ok=True)
    ARTIFACT.write_text(json.dumps(data, indent=2) + "\n")
    print(json.dumps(entry), flush=True)
    return entry


def _loop_steps_per_s(step_fn, n_steps, sync=None, warmup=100):
    """Time a host Python loop of ``step_fn()`` calls (the reference's
    protocol shape). ``sync`` reads a scalar back to force completion."""
    for _ in range(warmup):
        step_fn()
    if sync:
        sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step_fn()
    if sync:
        sync()
    dt = time.perf_counter() - t0
    return n_steps / dt, dt


def side_compat(args, device):
    """The gymnasium adapter, host loop, zero actions: per-step dispatch
    included (what an SB3/DummyVecEnv user pays)."""
    from usv_tpu_torch.compat.gym_adapter import UsvSimpleEnv

    env = UsvSimpleEnv(render_mode=None, device=device)
    env.reset(seed=args.seed)
    zero = np.zeros(2)

    def one_step():
        # the adapter hands the obs back as host numpy each step, which waits
        # for the device; float() on the reward makes the sync explicit
        _, r, _, _, _ = env.step(zero)
        return float(r)

    sps, dt = _loop_steps_per_s(one_step, args.steps, warmup=args.warmup)
    return _record(dict(
        name=f"compat_{device.type}_loop",
        steps_per_second=sps, seconds=dt, steps=args.steps,
        note=f"usv_tpu_torch.compat.UsvSimpleEnv, host loop, per-step dispatch on {device.type}",
    ), device)


def side_core(args, device):
    """The functional core at batch 1 through ``throughput``."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.vector import throughput

    out = throughput(make("usv-simple", device=device), num_envs=1, n_steps=args.steps, repeats=3)
    return _record(dict(
        name=f"core_scan_{device.type}_b1",
        steps_per_second=out["steps_per_second"], seconds=out["seconds"], steps=args.steps,
        note=f"functional core, vector.throughput at batch=1 on {device.type}; {SCAN_NOTE}",
    ), device)


def side_crossover(args, device):
    """Aggregate env-steps/s against the batch size: a host loop of
    ``BatchedEnv.step`` calls with the reward read back (the SB3-shaped
    usage) beside ``throughput``'s loop."""
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.vector import BatchedEnv, throughput

    handle = make("usv-simple", device=device)
    rows = []
    for b in args.batches:
        env = BatchedEnv(handle, num_envs=b)
        state, _ = env.reset(args.seed)
        zero = torch.zeros((b, 2), device=device)
        box = {"state": state}

        def one_step(env=env, zero=zero, box=box):
            box["state"], ts = env.step(box["state"], zero)
            box["r"] = ts.reward

        n = max(200, min(args.steps, 200_000 // b))
        sps, _ = _loop_steps_per_s(one_step, n, sync=lambda: float(box["r"][0]), warmup=20)
        amortized = throughput(handle, num_envs=b, n_steps=2048, repeats=2)
        rows.append(dict(
            batch=b,
            loop_aggregate_steps_per_second=sps * b,
            scan_aggregate_steps_per_second=amortized["steps_per_second"],
        ))
        print(rows[-1], flush=True)
    return _record(dict(
        name=f"crossover_{device.type}",
        rows=rows,
        note="aggregate env-steps/s: host-loop dispatch (one BatchedEnv.step call a step, "
             f"the reward read back) vs throughput's loop, by batch size; {SCAN_NOTE}",
    ), device)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--side", required=True, choices=["compat", "core", "crossover"])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batches", type=int, nargs="*", default=[1, 4, 16, 64, 256, 1024])
    return p


def main(argv=None) -> dict:
    """Run one side; returns the record added to the artifact."""
    args = build_parser().parse_args(argv)
    from usv_tpu_torch.envs.registry import resolve_device

    device = resolve_device(args.device)
    return dict(compat=side_compat, core=side_core, crossover=side_crossover)[args.side](args, device)


if __name__ == "__main__":
    main()

"""Policy-serving benchmark — port of ``tools/bench_policy.py``.

Two quantities of a policy bundle (``train/policy.py``), per batch width:

1. **Batch throughput** (actions/s): a chain of ``--chain`` data-dependent
   deterministic applies, each action fed back into the next obs
   (``obs <- tanh(obs + pad(action))``). JAX runs the chain inside one
   ``lax.scan`` program so that the number is device compute, not dispatch.
   The port captures the chain in one CUDA graph on the card and replays it
   (best of 3, ended by a scalar fetch); on the CPU it runs eagerly.
2. **Per-call latency** (ms, p50 and p95): one eager ``obs -> action`` call
   synced by a scalar fetch, the on-vehicle control-loop regime.

Without ``--bundle`` a fresh SAC-architecture policy (400x300, the reference
config's net, ``frame_stack`` 5: 715 inputs) is initialised from a seed.
``--bundle`` loads either package's bundle (a directory with ``params.pt`` or
a ``policy_np.npz``) through ``train/policy.py::load_policy``.

Usage (on the card unless ``--device`` names another)::

    python -m usv_tpu_torch.tools.bench_policy [--bundle runs/.../policy_best] \\
        [--batch 1 256 4096] [--chain 512] [--latency-calls 50] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

REPS = 3  # timed replays of the chain, best taken
ROW_KEYS = ("batch", "actions_per_s", "us_per_action", "dispatch_ms_p50", "dispatch_ms_p95")


def _fresh_policy(obs_dim: int = 143, action_dim: int = 2, frame_stack: int = 5, device=None,
                  seed: int = 0):
    """A policy of the reference SAC architecture (config.py:32, net
    400x300), initialised from ``seed``, for bundle-free runs."""
    from usv_tpu_torch.train.common import seeded_init
    from usv_tpu_torch.train.policy import Policy, build_module

    meta = dict(
        kind="sac", obs_dim=obs_dim * frame_stack, action_dim=action_dim,
        hidden=[400, 300], log_std_init=-3.0,
        action_low=[-1.0, -1.0], action_high=[1.0, 1.0],
        use_sde=False, frame_stack=frame_stack,
    )
    with seeded_init(seed):
        module = build_module(meta)
    return Policy(meta, module, device)


def chain_last(policy, obs, chain: int):
    """``a[0, 0]`` of the last of ``chain`` chained applies from ``obs``
    (JAX's ``chained(...)``, its scan's ``last[-1]``), a 0-d tensor. Each
    action, padded to the obs width, is added to the obs and the sum
    squashed, so every apply depends on the one before."""
    for _ in range(chain):
        a = policy(obs)
        obs = torch.tanh(obs + torch.nn.functional.pad(a, (0, obs.shape[1] - a.shape[1])))
    return a[0, 0]


def _chain_runner(policy, obs0, chain):
    """``run() -> 0-d tensor``: the chain from ``obs0``. On the card the
    ``chain`` applies are captured once in a CUDA graph and ``run`` replays
    it; on the CPU ``run`` is :func:`chain_last`."""
    if obs0.device.type != "cuda":
        return lambda: chain_last(policy, obs0, chain)
    static = obs0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain_last(policy, static, 2)  # warm-up off the default stream, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        last = chain_last(policy, static, chain)

    def run():
        graph.replay()
        return last

    return run


def bench_policy(policy, batch_sizes=(1, 256, 4096), chain: int = 512,
                 latency_calls: int = 50) -> list:
    """Serving throughput and latency of a ``Policy``: one dict per batch
    width. ``chain`` data-dependent applies run per timing rep."""
    obs_dim = policy.obs_dim
    rows = []
    for bs in batch_sizes:
        obs0 = torch.as_tensor(np.random.default_rng(0).standard_normal((bs, obs_dim)),
                               dtype=torch.float32).to(policy.device)
        run = _chain_runner(policy, obs0, chain)
        float(run())  # warm
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            float(run())  # scalar fetch = sync
            best = min(best, time.perf_counter() - t0)
        actions_s = bs * chain / best

        float(policy(obs0)[0, 0])  # warm the eager call
        lat = []
        for _ in range(latency_calls):
            t0 = time.perf_counter()
            float(policy(obs0)[0, 0])
            lat.append(time.perf_counter() - t0)
        lat_ms = sorted(lat)
        rows.append(dict(
            batch=bs,
            actions_per_s=actions_s,
            us_per_action=1e6 / actions_s,
            dispatch_ms_p50=1e3 * lat_ms[len(lat_ms) // 2],
            dispatch_ms_p95=1e3 * lat_ms[int(len(lat_ms) * 0.95)],
        ))
    return rows


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--bundle", default=None,
                   help="policy bundle dir (default: fresh 400x300 SAC net)")
    p.add_argument("--batch", type=int, nargs="+", default=[1, 256, 4096])
    p.add_argument("--chain", type=int, default=512, help="chained applies per timing rep")
    p.add_argument("--latency-calls", type=int, default=50)
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def main(argv=None) -> list:
    """Print a header (the policy, its dims and the device line) and one JSON
    line per batch width, floats rounded to 3 places; returns those rows."""
    args = build_parser().parse_args(argv)
    from usv_tpu_torch.envs.registry import resolve_device
    from usv_tpu_torch.tools.study_robust_band import device_line
    from usv_tpu_torch.train.policy import load_policy

    device = resolve_device(args.device)
    if args.bundle:
        policy = load_policy(args.bundle, device=device)
        src = args.bundle
    else:
        policy = _fresh_policy(device=device)
        src = "fresh 400x300 SAC net (no --bundle)"
    card = device_line(device)
    print(f"# policy: {src}  obs_dim={policy.obs_dim} act_dim={policy.action_dim}  "
          f"device={card}")
    rows = []
    for row in bench_policy(policy, tuple(args.batch), args.chain, args.latency_calls):
        rows.append({k: (round(v, 3) if isinstance(v, float) else v) for k, v in row.items()})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()

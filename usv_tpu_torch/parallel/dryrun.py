"""Multi-rank dry run — the counterpart of ``__graft_entry__.dryrun_multichip``.

:func:`dryrun_multichip` starts ``n`` rank processes and runs, on tiny
shapes (8 envs a rank), one shard-local-replay SAC training of 2 rounds and
4 gradient steps and then one sharded PPO iteration, asserting the counters
and that the replicated parameters agree across the ranks::

    python -m usv_tpu_torch.parallel.dryrun 2 [--device cpu] [--backend gloo]

On the card the ranks take NCCL, one card each; several ranks on one card
need ``--backend gloo``, which this says rather than chooses. With
``--device cpu`` the ranks run gloo on the CPU.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from usv_tpu_torch.parallel.dist import default_backend
from usv_tpu_torch.parallel.launch import run_ranks


def dryrun_multichip(n_devices: int, device=None, backend: Optional[str] = None,
                     timeout: float = 300.0) -> List[dict]:
    """Run the dry run on ``n_devices`` ranks; returns each rank's summary."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip runs on CUDA devices by default and none is "
                               "available; pass device='cpu' to run the ranks on the CPU")
        device = "cuda"
    device = torch.device(device).type
    backend = backend or default_backend(device)
    if backend == "nccl" and n_devices > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one card a rank: {n_devices} ranks, "
                         f"{torch.cuda.device_count()} card(s); pass backend='gloo' to put "
                         "several ranks on one card")
    out = run_ranks("usv_tpu_torch.parallel.dryrun:_rank", n_devices,
                    dict(device=device, backend=backend), timeout=timeout, echo=True)
    for key in ("sac_reward", "ppo_reward", "sac_param", "ppo_param"):
        values = {r[key] for r in out}
        _check(len(values) == 1, f"the ranks disagree on {key}: {values}")
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _rank(device: str, backend: str) -> dict:
    import os

    from usv_tpu_torch.envs import make
    from usv_tpu_torch.parallel.dist import initialize_distributed
    from usv_tpu_torch.parallel.mesh import make_env_mesh
    from usv_tpu_torch.parallel.sharded import shard_ppo_train_state, shard_sac_train_state
    from usv_tpu_torch.train.ppo import PpoConfig, PpoLearner
    from usv_tpu_torch.train.sac import SacConfig, SacLearner

    rank_dev = None
    if device == "cpu":
        rank_dev = "cpu"
    elif backend != "nccl":  # several ranks may share a card
        rank_dev = f"cuda:{int(os.environ['LOCAL_RANK']) % torch.cuda.device_count()}"
    initialize_distributed(backend=backend, device=rank_dev)
    mesh = make_env_mesh()
    n = mesh.size
    handle = make("usv-simple", device=mesh.device)
    num_envs = 8 * n  # tiny shapes: 8 envs a rank
    cfg = SacConfig(num_envs=num_envs, buffer_size=128 * n, batch_size=4 * n, learning_starts=0,
                    train_freq=2, gradient_steps=2, hidden=(64, 64), frame_stack=2,
                    shard_local_replay=True)
    learner = SacLearner(handle, cfg, mesh=mesh)
    ts = shard_sac_train_state(learner.init(seed=0), mesh)
    ts, reward = learner.train_rounds(ts, 2)
    _check(ts.grad_steps == 4, f"expected 4 grad steps, got {ts.grad_steps}")
    sac_reward = float(reward)
    if mesh.rank == 0:
        print(f"dryrun_multichip({n}): SAC ok — shard-local-replay train step (collect+update) "
              f"over {num_envs} envs on {n} ranks ({mesh.backend}, {mesh.device}), reward sum "
              f"{sac_reward:.3f}, grad steps {ts.grad_steps}", flush=True)

    pcfg = PpoConfig(n_steps=8, batch_size=4 * n, n_epochs=2, num_envs=num_envs,
                     pi_hidden=(64, 64), vf_hidden=(64, 64), frame_stack=2)
    plearner = PpoLearner(handle, pcfg)
    pts = shard_ppo_train_state(plearner.init(seed=0), mesh)
    pts, preward = plearner.train_iteration(pts)
    _check(pts.update_count == 1, f"expected 1 iteration, got {pts.update_count}")
    if mesh.rank == 0:
        print(f"dryrun_multichip({n}): PPO ok — sharded iteration over {num_envs} envs, "
              f"mean reward {float(preward):.3f}", flush=True)
    return dict(rank=mesh.rank, backend=mesh.backend, device=str(mesh.device),
                sac_reward=sac_reward, ppo_reward=float(preward), grad_steps=ts.grad_steps,
                update_count=pts.update_count, collectives=mesh.traffic.calls,
                collective_bytes=mesh.traffic.bytes,
                sac_param=float(sum(p.double().sum() for p in ts.actor.parameters())),
                ppo_param=float(sum(p.double().sum() for p in pts.model.parameters())))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int, nargs="?", default=2)
    p.add_argument("--device", default=None, help="cpu, or the CUDA devices (default)")
    p.add_argument("--backend", default=None, help="nccl (CUDA default) or gloo")
    args = p.parse_args(argv)
    for r in dryrun_multichip(args.n_devices, args.device, args.backend):
        print(r, flush=True)


if __name__ == "__main__":
    main()

"""Two processes brought up through the port's
``initialize_distributed(coordinator, 2, rank)`` on gloo, on the CPU: the
counterparts of ``tests/test_multihost.py`` (an env step, a SAC training of
4 gradient steps, one PPO iteration; both processes agree on the summed
results and hold bit-identical replicated parameters), the per-rank seeds,
and ``run_sac --shard --shard-local-replay`` under a 2-rank launch (one
logdir, written by rank 0; ``--resume`` from the sharded checkpoint).
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from usv_tpu_torch.parallel.dist import fold_host_key
from usv_tpu_torch.parallel.launch import run_ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
CLI = ["--env", "usv-simple", "--num-envs", "4", "--train-freq", "2", "--gradient-steps", "2",
       "--batch-size", "16", "--buffer-size", "64", "--learning-starts", "8", "--rounds-per-block", "2",
       "--eval-every-blocks", "1", "--eval-steps", "5", "--shard", "--shard-local-replay",
       "--device", "cpu"]


def ranks(worker, timeout=120.0, **kwargs):
    return run_ranks(f"test_torch_multihost:{worker}", 2, kwargs, timeout=timeout, paths=[TESTS])


def host_worker(logdir):
    """The hosts' cases under an explicit ``initialize_distributed``, then
    the group taken down and both CLI runs in the same two processes (one
    launch for the file)."""
    import torch.distributed as dist

    from usv_tpu_torch.envs import make
    from usv_tpu_torch.parallel import initialize_distributed, make_env_mesh
    from usv_tpu_torch.parallel.dist import shutdown_distributed
    from usv_tpu_torch.parallel.sharded import shard_ppo_train_state, shard_sac_train_state
    from usv_tpu_torch.train.ppo import PpoConfig, PpoLearner
    from usv_tpu_torch.train.sac import SacConfig, SacLearner
    from usv_tpu_torch.vector import BatchedEnv

    pid = int(os.environ["RANK"])
    assert initialize_distributed(f"127.0.0.1:{os.environ['MASTER_PORT']}", 2, pid, device="cpu")
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    mesh = make_env_mesh()
    out = dict(pid=pid, seeds=[fold_host_key(0), fold_host_key(0), fold_host_key(0, 0), fold_host_key(0, 1)])

    # an env step of 16 envs, 8 a host, reset from the host's own seed; the
    # global mean reward is summed over the hosts
    handle = make("usv-simple", device="cpu")
    benv = BatchedEnv(handle, 8)
    state, _ = benv.reset(fold_host_key(0))
    _, step = benv.step(state, torch.zeros(8, 2))
    out["mean_reward"] = float(mesh.all_sum([step.reward.sum()])[0] / 16)

    cfg = SacConfig(num_envs=16, buffer_size=512, batch_size=32, learning_starts=0, train_freq=2,
                    gradient_steps=2, hidden=(32, 32), frame_stack=2, shard_local_replay=True)
    learner = SacLearner(handle, cfg, mesh=mesh)
    ts = shard_sac_train_state(learner.init(0), mesh)
    ts, reward = learner.train_rounds(ts, 2)
    out["sac"] = dict(reward=float(reward), grad_steps=ts.grad_steps,
                      params={k: v.clone() for k, v in ts.actor.state_dict().items()})

    pcfg = PpoConfig(n_steps=8, batch_size=16, n_epochs=2, num_envs=16, pi_hidden=(32, 32),
                     vf_hidden=(32, 32), frame_stack=2)
    plearner = PpoLearner(handle, pcfg)
    pts = shard_ppo_train_state(plearner.init(0), mesh)
    pts, preward = plearner.train_iteration(pts)
    out["ppo"] = dict(reward=float(preward), update_count=pts.update_count,
                      params={k: v.clone() for k, v in pts.model.state_dict().items()})
    # run_sac.main brings its group up from the launcher's environment: each
    # run on a port of its own, so that no rank meets a store left from the
    # group before it
    ports = torch.tensor(_two_ports() if pid == 0 else [0, 0])
    mesh.broadcast([ports])
    shutdown_distributed()

    os.environ["MASTER_PORT"] = str(int(ports[0]))
    out["cli"] = _cli(CLI + ["--total-steps", "48", "--logdir", logdir])
    if pid == 0:  # the logdir as the first run left it
        out["cli"]["metrics"] = [json.loads(x) for x in open(f"{logdir}/metrics.jsonl") if x.strip()]
        out["cli"]["bundles"] = [os.path.isdir(f"{logdir}/{b}") for b in ("policy", "policy_best")]
        saved = torch.load(f"{logdir}/ckpt/48/train_state.pt", weights_only=True)["state"]
        out["cli"]["saved"] = dict(blocks=saved["buffer"]["blocks"], size=saved["buffer"]["size"],
                                   width=saved["batch"]["frames"].shape[0])
    os.environ["MASTER_PORT"] = str(int(ports[1]))
    out["resumed"] = _cli(CLI + ["--total-steps", "64", "--logdir", logdir, "--resume"])
    return out


def _two_ports():
    from usv_tpu_torch.parallel.launch import free_port

    ports = [free_port()]
    while len(ports) < 2:
        ports = sorted({*ports, free_port()})
    return ports


def _cli(argv):
    import torch.distributed as dist

    from usv_tpu_torch.train import run_sac

    learner, ts = run_sac.main(argv)
    return dict(rank=ts.mesh.rank, size=ts.mesh.size, env_steps=ts.env_steps, grad_steps=ts.grad_steps,
                buffer_size=ts.buffer.size, group_left_up=dist.is_initialized(),
                params={k: v.clone() for k, v in ts.actor.state_dict().items()})


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    return ranks("host_worker", logdir=str(tmp_path_factory.mktemp("cli") / "sac"))


def test_two_process_distributed_env_step(hosts):
    assert hosts[0]["mean_reward"] == pytest.approx(hosts[1]["mean_reward"], rel=1e-6)


def test_two_process_distributed_sac_training(hosts):
    a, b = (h["sac"] for h in hosts)
    assert a["reward"] == pytest.approx(b["reward"], rel=1e-6)
    assert a["grad_steps"] == b["grad_steps"] == 4
    # the replicated parameters stayed bit-identical across the processes
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def test_two_process_distributed_ppo_training(hosts):
    a, b = (h["ppo"] for h in hosts)
    assert a["reward"] == pytest.approx(b["reward"], rel=1e-6)
    assert a["update_count"] == b["update_count"] == 1
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def test_fold_host_key_is_per_rank_and_repeatable(hosts):
    seeds = [h["seeds"] for h in hosts]
    assert seeds[0][0] != seeds[1][0]  # distinct per rank
    for pid, s in enumerate(seeds):
        assert s[0] == s[1] == s[2 + pid]  # the same again, and the explicit index
    # a rerun in another process (this one, no group): the same seeds
    assert fold_host_key(0) == seeds[0][0] and fold_host_key(0, 1) == seeds[1][0]


def test_run_sac_shard_cli_on_two_ranks(hosts):
    """``run_sac --shard --shard-local-replay`` launched on 2 ranks: both
    train the same replicated run, rank 0 alone writes the logdir, the
    group is gone when ``main`` returns, and ``--resume`` continues from the
    sharded checkpoint."""
    out = [h["cli"] for h in hosts]
    assert [(r["rank"], r["size"]) for r in out] == [(0, 2), (1, 2)]
    assert out[0]["env_steps"] == out[1]["env_steps"] == 12  # 6 rounds of 2 steps
    assert all(torch.equal(out[0]["params"][k], out[1]["params"][k]) for k in out[0]["params"])
    assert not any(r["group_left_up"] for r in out)
    lines = out[0]["metrics"]
    assert [x["step"] for x in lines if "step" in x] == [16, 32, 48]  # one writer
    assert out[0]["bundles"] == [True, True]
    saved = out[0]["saved"]
    assert saved["blocks"] == 2 and saved["size"] == out[0]["buffer_size"]
    assert saved["width"] == 4  # the global layout

    resumed = [h["resumed"] for h in hosts]
    assert resumed[0]["env_steps"] == resumed[1]["env_steps"] == 16
    assert resumed[0]["buffer_size"] == out[0]["buffer_size"] + 2 * 4 * 2 // 2

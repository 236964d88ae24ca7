"""The port's data-parallel layer (``usv_tpu_torch/parallel``, the shard-local
replay, the sharded SAC and PPO learners and checkpoints) on the CPU: the
counterparts of ``tests/test_parallel.py``, with ranks in place of JAX's
virtual devices.

Ranks are processes started through ``parallel.launch.run_ranks`` (a free
port each time, one thread a rank, a join timeout that kills them), running
gloo on the CPU; most runs have 2 ranks, the cross-topology restore 4, then
2, then 1. Each spawned run does several cases at once (the module-scoped
fixtures), and the tests read its parts. What a run on ranks is held to:

* env steps: the ranks' rows concatenate to the one-process rows exactly
  (all 8 ids);
* SAC over 2 rounds: the first collect's rows bit for bit; parameters at
  JAX's gates (``tests/test_parallel.py:168``: rtol 1e-4, atol 1e-5, the
  reward at 1e-5); the same with shard-local replay against the 2-shard
  logical mesh (one process holding both blocks);
* PPO: the mean reward at rel 1e-4 and the parameters within 5e-3 max-abs
  (``tests/test_parallel.py:264-297``): the clipped objective turns a
  reduction-order difference into a finite step where a ratio crosses the
  clip;
* the checkpoint of a sharded state is the file of the one-process state
  (the replay and env rows bit for bit);
* traffic, on the mesh's byte counter: a shard-local SAC update moves the
  same bytes at batch 32 and 256 (its gradients and one scalar), a
  grouped-shuffle PPO optimizer step under 2% more as the rollout grows 4x.

The JAX package's own functions are held against the port's directly: the
shard-local insert, the sample with injected per-shard indices and the
re-layout bit for bit, and one shard-local SAC round of the port's 8-shard
logical learner against JAX's on its 8-device mesh with JAX's draws (the
helpers of ``tests/test_torch_sac.py``; its tolerances).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from usv_tpu_torch.envs import make
from usv_tpu_torch.parallel import initialize_distributed, make_env_mesh
from usv_tpu_torch.parallel.dryrun import dryrun_multichip
from usv_tpu_torch.parallel.launch import run_ranks
from usv_tpu_torch.parallel.sharded import shard_ppo_train_state, shard_sac_train_state
from usv_tpu_torch.train.buffer import (
    ReplayBuffer,
    buffer_add_traj_local,
    buffer_init,
    buffer_reshard_local,
    buffer_sample_local,
)
from usv_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from usv_tpu_torch.train.common import new_generator
from usv_tpu_torch.train.ppo import PpoConfig, PpoLearner
from usv_tpu_torch.train.sac import SacConfig, SacLearner
from usv_tpu_torch.vector import BatchedEnv

TESTS = os.path.dirname(os.path.abspath(__file__))
SAC = dict(num_envs=16, buffer_size=512, batch_size=32, learning_starts=0, train_freq=2,
           gradient_steps=2, hidden=(32, 32), frame_stack=2)
WARMUP = dict(learning_starts=10**6)  # collect only: a run on ranks equals one process bit for bit
PPO = dict(n_steps=16, batch_size=32, n_epochs=2, num_envs=16, pi_hidden=(32, 32),
           vf_hidden=(32, 32), frame_stack=2)
ACTION_DIMS = {"usv-simple": 2, "usv-asmc-simple": 2, "usv-aitsmc-simple": 2,
               "usv-asmc-ca-v0": 2, "usv-curved-aitsmc": 2,
               "usv-asmc-v0": 1, "usv-pid-v0": 1, "usv-asmc-ye-int-v0": 1}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ranks(worker, n, timeout=120.0, **kwargs):
    return run_ranks(f"test_torch_parallel:{worker}", n, kwargs, timeout=timeout, paths=[TESTS])


def _up():
    """This rank's gloo group, from the launcher's environment, and its mesh."""
    initialize_distributed(device="cpu")
    return make_env_mesh()


def _cpu(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def _sac_params(ts):
    return {**{f"actor.{k}": v for k, v in _cpu(ts.actor.state_dict()).items()},
            **{f"critic.{k}": v for k, v in _cpu(ts.critic.state_dict()).items()},
            **{f"target.{k}": v for k, v in _cpu(ts.target_critic.state_dict()).items()},
            "log_alpha": ts.log_alpha.detach().clone()}


def _filled(buf: ReplayBuffer, blocks: int):
    return {f: getattr(buf, f).reshape(blocks, -1, *getattr(buf, f).shape[1:])[:, :buf.size].clone()
            for f in ReplayBuffer.FIELDS}


# ------------------------------------------------------------- rank workers


def _env_step_rows(env_id, mesh=None):
    """One auto-resetting step of 16 envs from a seeded reset, at 0.3 actions
    and a seeded reset block: (obs, reward, done) of this process's rows."""
    handle = make(env_id, device="cpu")
    benv = BatchedEnv(handle, 16)
    g = new_generator(3, "cpu")
    width = handle.n_uniform(handle.cfg)
    state, _ = benv.reset(uniform=torch.rand((16, width), generator=g))
    actions = torch.full((16, ACTION_DIMS[env_id]), 0.3)
    reset = torch.rand((16, width), generator=g)
    if mesh is not None:
        from usv_tpu_torch.parallel.mesh import shard_env_batch

        state = shard_env_batch(state, mesh)
        actions, reset = mesh.local(actions), mesh.local(reset)
    _, ts = benv.step(state, actions, uniform=reset)
    return ts.obs, ts.reward, ts.done


def _sac_run(mesh, shard_local: bool):
    """2 rounds of the small SAC from seed 0: the buffer's rows after the
    first, the parameters and the reward sum after both."""
    cfg = SacConfig(**SAC, shard_local_replay=shard_local)
    learner = SacLearner(make("usv-simple", device="cpu"), cfg, mesh=mesh if shard_local else None)
    ts = learner.init(0)
    if mesh is not None:
        ts = shard_sac_train_state(ts, mesh)
    ts, r1 = learner.train_rounds(ts, 1)
    rows = {f: getattr(ts.buffer, f).clone() for f in ReplayBuffer.FIELDS}
    ts, r2 = learner.train_rounds(ts, 1)
    return dict(rows=rows, size=ts.buffer.size, params=_sac_params(ts), reward=float(r1 + r2),
                grad_steps=ts.grad_steps)


def _ppo_run(mesh, **overrides):
    learner = PpoLearner(make("usv-simple", device="cpu"), PpoConfig(**{**PPO, **overrides}))
    ts = learner.init(0)
    if mesh is not None:
        ts = shard_ppo_train_state(ts, mesh)
    ts, reward = learner.train_iteration(ts)
    return dict(reward=float(reward), params=_cpu(ts.model.state_dict()), frames=ts.batch.frames.clone(),
                update_count=ts.update_count)


def _sac_update_bytes(mesh, shard_local, batch_size):
    """Bytes and calls of the mesh's collectives in one SAC update."""
    cfg = SacConfig(**{**SAC, "batch_size": batch_size}, shard_local_replay=shard_local)
    learner = SacLearner(make("usv-simple", device="cpu"), cfg, mesh=mesh if shard_local else None)
    ts = shard_sac_train_state(learner.init(0), mesh)
    ts, _ = learner.train_rounds(ts, 1)  # fill enough to sample
    mesh.traffic.reset()
    learner._update_once(ts, batch_size)
    return mesh.traffic.bytes, mesh.traffic.calls


def _ppo_step_bytes(mesh, n_steps, groups, rotate=False):
    """Collective bytes per optimizer step of one PPO iteration."""
    cfg = PpoConfig(n_steps=n_steps, batch_size=64, n_epochs=1, num_envs=16, pi_hidden=(32, 32),
                    vf_hidden=(32, 32), frame_stack=2, shuffle_groups=groups,
                    shuffle_group_rotate=rotate)
    learner = PpoLearner(make("usv-simple", device="cpu"), cfg)
    ts = shard_ppo_train_state(learner.init(0), mesh)
    mesh.traffic.reset()
    ts, _ = learner.train_iteration(ts)
    return mesh.traffic.bytes / ts.opt_steps


def bundle_worker(path, topology_path):
    """Every 2-rank case in one launch (the cross-topology restore's second
    leg among them: the checkpoint that 4 ranks saved under
    ``topology_path``)."""
    mesh = _up()
    out = dict(size=mesh.size, rank=mesh.rank, backend=mesh.backend)
    learner = SacLearner(make("usv-simple", device="cpu"), SacConfig(**SAC, shard_local_replay=True),
                         mesh=mesh)
    out["topology"] = _restore_on(learner, mesh, topology_path)
    out["env"] = {env_id: _env_step_rows(env_id, mesh) for env_id in ACTION_DIMS}
    out["sac_global"] = _sac_run(mesh, False)
    out["sac_local"] = _sac_run(mesh, True)
    out["ppo"] = _ppo_run(mesh)
    out["ppo_grouped"] = _ppo_run(mesh, n_steps=16, batch_size=64, shuffle_groups=8, num_envs=32)
    out["ppo_rotate"] = _ppo_run(mesh, shuffle_groups=4, shuffle_group_rotate=True)
    out["sac_bytes"] = {(local, bs): _sac_update_bytes(mesh, local, bs)
                        for local in (True, False) for bs in (32, 256)}
    out["ppo_bytes"] = {(groups, n_steps, rotate): _ppo_step_bytes(mesh, n_steps, groups, rotate)
                        for groups, rotate in ((0, False), (2, False), (2, True))
                        for n_steps in (32, 128)}

    # the sharded checkpoint: two warm-up rounds (no update) saved, then
    # three rounds saved, restored into another seed's state, sharded, trained on
    learner = SacLearner(make("usv-simple", device="cpu"), SacConfig(**{**SAC, **WARMUP}))
    ts, _ = learner.train_rounds(shard_sac_train_state(learner.init(0), mesh), 2)
    save_checkpoint(f"{path}/ckpt", ts, 1)
    learner = SacLearner(make("usv-simple", device="cpu"), SacConfig(**SAC))
    ts = shard_sac_train_state(learner.init(0), mesh)
    ts, _ = learner.train_rounds(ts, 3)
    save_checkpoint(f"{path}/ckpt", ts, 7)
    restored, step = restore_checkpoint(f"{path}/ckpt", learner.init(1))  # run_sac --resume's path
    restored = shard_sac_train_state(restored, mesh)
    out["ckpt"] = dict(step=step, saved=_sac_params(ts), restored=_sac_params(restored),
                       frames=(ts.batch.frames.clone(), restored.batch.frames.clone()),
                       rows=(_filled(ts.buffer, 1), _filled(restored.buffer, 1)),
                       counters=(restored.env_steps, restored.grad_steps, restored.buffer.size))
    restored, reward = learner.train_rounds(restored, 2)
    out["ckpt"]["reward_after"] = float(reward)

    # shard-local SAC trains, and buffer.size counts local rows
    learner = SacLearner(make("usv-simple", device="cpu"), SacConfig(**SAC, shard_local_replay=True),
                         mesh=mesh)
    ts = shard_sac_train_state(learner.init(0), mesh)
    ts, reward = learner.train_rounds(ts, 4)
    out["local_trains"] = dict(reward=float(reward), grad_steps=ts.grad_steps, size=ts.buffer.size,
                               finite=all(bool(torch.isfinite(p).all()) for p in ts.actor.parameters()))
    return out


def topology_worker(path):
    """The cross-topology restore's first leg: shard-local SAC trained on
    these ranks and saved."""
    mesh = _up()
    learner = SacLearner(make("usv-simple", device="cpu"), SacConfig(**SAC, shard_local_replay=True),
                         mesh=mesh)
    ts = shard_sac_train_state(learner.init(0), mesh)
    ts, _ = learner.train_rounds(ts, 4)
    save_checkpoint(f"{path}/ckpt", ts, 5)
    return dict(size=ts.buffer.size, params=_sac_params(ts))


def _restore_on(learner, mesh, path):
    """Restore the whole buffer, re-lay it for ``mesh``, shard, train on."""
    restored, step = restore_checkpoint(f"{path}/ckpt", learner.init(1))
    src_blocks = restored.buffer.blocks
    cfg = learner.cfg
    restored.buffer = buffer_reshard_local(restored.buffer, src_blocks, mesh.size,
                                           insert_rows=cfg.train_freq * cfg.num_envs // mesh.size)
    rows = _filled(restored.buffer, mesh.size)["obs"].reshape(-1, learner.obs_dim)
    size, params = restored.buffer.size, _sac_params(restored)
    ts = shard_sac_train_state(restored, mesh)
    ts, reward = learner.train_rounds(ts, 2)
    return dict(step=step, src_blocks=src_blocks, size=size, rows=rows, params=params,
                reward=float(reward), size_after=ts.buffer.size)


# ------------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def saved_on_four(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("topology"))
    return path, ranks("topology_worker", 4, path=path)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory, saved_on_four):
    path = tmp_path_factory.mktemp("bundle")
    return ranks("bundle_worker", 2, path=str(path), topology_path=saved_on_four[0]), path


def one_process_sac(shard_local, n_shards=2):
    """The run in one process on a logical mesh of ``n_shards`` (or none)."""
    return _sac_run(make_env_mesh(n_shards=n_shards) if n_shards else None, shard_local)


def assert_params(got, want, rtol=1e-4, atol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol, err_msg=k)


def _flat(tree, prefix=""):
    """The tensors of a packed (nested dict) state by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def max_drift(got, want):
    return max(float((got[k] - want[k]).abs().max()) for k in want)


# --------------------------------------------------------------------- tests


def test_mesh_has_n_ranks(bundle):
    out, _ = bundle
    assert [(r["size"], r["rank"], r["backend"]) for r in out] == [(2, 0, "gloo"), (2, 1, "gloo")]
    logical = make_env_mesh(n_shards=8)
    assert logical.size == 8 and logical.logical and list(logical.shards) == list(range(8))
    assert make_env_mesh().size == 1


def test_sharded_env_step_matches_unsharded(bundle):
    out, _ = bundle
    want = _env_step_rows("usv-simple")
    for got_part, want_part in zip(zip(*(r["env"]["usv-simple"] for r in out)), want):
        assert torch.equal(torch.cat(got_part), want_part)


@pytest.mark.parametrize("env_id", sorted(ACTION_DIMS))
def test_sharded_step_matches_unsharded_all_families(bundle, env_id):
    out, _ = bundle
    want = _env_step_rows(env_id)
    for name, got_part, want_part in zip(("obs", "reward", "done"),
                                         zip(*(r["env"][env_id] for r in out)), want):
        assert torch.equal(torch.cat(got_part), want_part), name


def test_sharded_sac_round_runs(bundle):
    out, _ = bundle
    run = out[0]["sac_global"]
    assert np.isfinite(run["reward"]) and run["grad_steps"] == 4
    assert all(bool(torch.isfinite(v).all()) for v in run["params"].values())


def test_sharded_sac_training_matches_unsharded(bundle):
    """Global replay on 2 ranks against the one-process run: the first
    collect's rows bit for bit (each rank's are its env columns of every
    step-row) against the run on a 2-shard logical mesh (its actor called on
    each shard's rows, at the rank's width), then JAX's gates on the
    parameters and the reward against that run and the run with no mesh."""
    out, _ = bundle
    logical, plain = one_process_sac(False), one_process_sac(False, n_shards=0)
    B, half = SAC["num_envs"], SAC["num_envs"] // 2
    assert_params(logical["params"], plain["params"])
    for r in out:
        run = r["sac_global"]
        assert run["grad_steps"] == logical["grad_steps"] == 4
        assert run["size"] == logical["size"] // 2
        for f, rows in logical["rows"].items():
            steps = rows.reshape(-1, B, *rows.shape[1:])[:, r["rank"] * half:(r["rank"] + 1) * half]
            assert torch.equal(run["rows"][f], steps.reshape(rows.shape[0] // 2, *rows.shape[1:])), f
        for want in (logical, plain):
            assert run["reward"] == pytest.approx(want["reward"], rel=1e-5, abs=1e-5)
            assert_params(run["params"], want["params"])
            np.testing.assert_allclose(float(run["params"]["log_alpha"]),
                                       float(want["params"]["log_alpha"]), rtol=1e-5, atol=1e-6)


def test_production_shape_sac_sharded_matches_unsharded(bundle):
    """Shard-local replay on both sides (tests/test_parallel.py:230): 2 ranks
    against the 2-shard logical mesh. Each rank's capacity block is the
    logical buffer's block, bit for bit."""
    out, _ = bundle
    want = one_process_sac(True)
    for r in out:
        run = r["sac_local"]
        assert run["size"] == want["size"] == 2 * SAC["train_freq"] * SAC["num_envs"] // 2
        for f, rows in want["rows"].items():
            assert torch.equal(run["rows"][f], rows.reshape(2, -1, *rows.shape[1:])[r["rank"]]), f
        assert run["reward"] == pytest.approx(want["reward"], rel=1e-4)
        assert_params(run["params"], want["params"])


def test_sharded_ppo_iteration_matches_unsharded(bundle):
    out, _ = bundle
    want = _ppo_run(None)
    for r in out:
        assert r["ppo"]["update_count"] == 1
        assert r["ppo"]["reward"] == pytest.approx(want["reward"], rel=1e-4, abs=1e-5)
        assert max_drift(r["ppo"]["params"], want["params"]) < 5e-3
    assert out[0]["ppo"]["params"].keys() == want["params"].keys()
    assert all(torch.equal(out[0]["ppo"]["params"][k], out[1]["ppo"]["params"][k]) for k in want["params"])


def test_grouped_shuffle_sharded_matches_unsharded(bundle):
    out, _ = bundle
    want = _ppo_run(None, n_steps=16, batch_size=64, shuffle_groups=8, num_envs=32)
    for r in out:
        assert r["ppo_grouped"]["reward"] == pytest.approx(want["reward"], rel=1e-4, abs=1e-5)
        assert max_drift(r["ppo_grouped"]["params"], want["params"]) < 5e-3


def test_rotate_groups_membership_and_placement(bundle):
    """The rotated iteration on 2 ranks: each rank's frame stack is its rows
    of the one-process rotated stack (the state was assembled, permuted
    and split again), which is a non-identity row permutation of the
    unrotated one's; the parameters within the PPO gates."""
    out, _ = bundle
    want = _ppo_run(None, shuffle_groups=4, shuffle_group_rotate=True)
    base = _ppo_run(None, shuffle_groups=4)
    frames = torch.cat([r["ppo_rotate"]["frames"] for r in out])
    np.testing.assert_allclose(frames.numpy(), want["frames"].numpy(), rtol=1e-6, atol=1e-6)
    rot, plain = want["frames"].reshape(16, -1), base["frames"].reshape(16, -1)
    assert not torch.equal(rot, plain)
    key = lambda x: x.sum(1).sort().values  # noqa: E731
    np.testing.assert_allclose(key(rot).numpy(), key(plain).numpy(), rtol=1e-6)
    for r in out:
        assert r["ppo_rotate"]["reward"] == pytest.approx(want["reward"], rel=1e-4, abs=1e-5)
        assert max_drift(r["ppo_rotate"]["params"], want["params"]) < 5e-3


def test_shard_local_update_replay_traffic_is_batch_independent(bundle):
    """A shard-local update moves its gradients and the mean log-prob, in
    three all-reduces, whatever the batch; the global mode, which evaluates
    each sampled row on the rank that wrote it, moves the same."""
    out, _ = bundle
    learner = SacLearner(make("usv-simple", device="cpu"), SacConfig(**SAC))
    ts = learner.init(0)
    grad_bytes = 4 * (sum(p.numel() for p in ts.critic.parameters())
                      + sum(p.numel() for p in ts.actor.parameters()) + 1)
    for r in out:
        l32, l256 = r["sac_bytes"][(True, 32)], r["sac_bytes"][(True, 256)]
        assert l32[0] > 0 and l32 == l256 == (grad_bytes, 3)
        assert r["sac_bytes"][(False, 32)] == r["sac_bytes"][(False, 256)] == l32


def test_shard_local_shuffle_traffic(bundle):
    """Bytes per PPO optimizer step as the rollout grows 4x: gradients and
    the advantage's two scalars a step, under 2% more (the per-iteration
    reward sum and, with rotation, the state assembly spread over more
    steps: fewer bytes a step), for the grouped shuffle, the rotation and the
    global shuffle."""
    out, _ = bundle
    for r in out:
        b = r["ppo_bytes"]
        for groups, rotate in ((2, False), (2, True), (0, False)):
            small, large = b[(groups, 32, rotate)], b[(groups, 128, rotate)]
            assert small > 0 and large < 1.02 * small, (groups, rotate, small, large)


def test_sharded_checkpoint_roundtrip(bundle, tmp_path):
    """Saved on 2 ranks, the file is the one-process state's (bit for bit
    after two warm-up rounds, where the two runs are equal), its replay in
    the global layout (each rank's rows are its env columns of every
    step-row); restored into another seed's sharded state it gives back
    each rank's rows, the replicated parameters and the counters, and
    training continues."""
    out, path = bundle
    for r in out:
        c = r["ckpt"]
        assert c["step"] == 7
        assert all(torch.equal(c["saved"][k], c["restored"][k]) for k in c["saved"])
        assert torch.equal(*c["frames"])
        assert all(torch.equal(c["rows"][0][f], c["rows"][1][f]) for f in ReplayBuffer.FIELDS)
        assert c["counters"] == (3 * SAC["train_freq"], 3 * 2, 3 * SAC["train_freq"] * SAC["num_envs"] // 2)
        assert np.isfinite(c["reward_after"])
    learner = SacLearner(make("usv-simple", device="cpu"), SacConfig(**{**SAC, **WARMUP}))
    ts, _ = learner.train_rounds(learner.init(0), 2)
    save_checkpoint(tmp_path / "ckpt", ts, 1)
    got = _flat(torch.load(path / "ckpt/1/train_state.pt", weights_only=True)["state"])
    want = _flat(torch.load(tmp_path / "ckpt/1/train_state.pt", weights_only=True)["state"])
    assert got.keys() == want.keys() and any(k.startswith("buffer/") for k in want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    # the trained file restored whole: the ranks' rows are its env columns
    whole, _ = restore_checkpoint(path / "ckpt", SacLearner(make("usv-simple", device="cpu"),
                                                            SacConfig(**SAC)).init(1), step=7)
    B, half = SAC["num_envs"], SAC["num_envs"] // 2
    for r in out:
        for f, rows in _filled(whole.buffer, 1).items():
            steps = rows.reshape(-1, B, *rows.shape[2:])[:, r["rank"] * half:(r["rank"] + 1) * half]
            assert torch.equal(r["ckpt"]["rows"][0][f].reshape(-1, half, *rows.shape[2:]), steps), f


def test_cross_topology_checkpoint_restore(saved_on_four, bundle):
    """Shard-local replay saved on 4 ranks, restored whole, re-laid with
    ``buffer_reshard_local`` and trained on 2 ranks and on 1: the row
    multiset is kept exactly and the fill adds up."""
    path, saved = saved_on_four
    on_two = [r["topology"] for r in bundle[0]]
    learner = SacLearner(make("usv-simple", device="cpu"), SacConfig(**SAC, shard_local_replay=True),
                         mesh=make_env_mesh(n_shards=1))
    on_one = _restore_on(learner, make_env_mesh(n_shards=1), path)
    src_size = saved[0]["size"]
    assert src_size == 4 * SAC["train_freq"] * SAC["num_envs"] // 4
    file = torch.load(f"{path}/ckpt/5/train_state.pt", weights_only=True)["state"]["buffer"]
    assert file["blocks"] == 4 and file["size"] == src_size
    src_rows = file["obs"].numpy()
    src_rows = src_rows[np.lexsort(src_rows.T)]
    for n_dst, results in ((2, on_two), (1, [on_one])):
        for r in results:
            assert r["step"] == 5 and r["src_blocks"] == 4
            assert all(torch.equal(r["params"][k], saved[0]["params"][k]) for k in r["params"])
            assert r["size"] == 4 * src_size // n_dst
            rows = r["rows"].numpy()
            np.testing.assert_array_equal(rows[np.lexsort(rows.T)], src_rows)
            assert np.isfinite(r["reward"])
            assert r["size_after"] == 4 * src_size // n_dst + 2 * SAC["train_freq"] * SAC["num_envs"] // n_dst


def test_buffer_reshard_local_refuses_undefined_layouts():
    buf = buffer_init(64, 3, 2)
    with pytest.raises(ValueError):
        buffer_reshard_local(buf, 7, 2)      # capacity 64 % 7 != 0
    with pytest.raises(ValueError):
        buffer_reshard_local(buf, 8, 3)      # capacity 64 % 3 != 0
    buf.size = 3
    with pytest.raises(ValueError):
        buffer_reshard_local(buf, 4, 8)      # 4*3 = 12 rows % 8 shards != 0
    buf.size = 4
    with pytest.raises(ValueError):
        buffer_reshard_local(buf, 4, 2, insert_rows=3)  # head 8 % 3 != 0
    out = buffer_reshard_local(buf, 4, 2, insert_rows=4)
    assert out.size == 8 and out.blocks == 2


def test_shard_local_sac_trains(bundle):
    out, _ = bundle
    for r in out:
        t = r["local_trains"]
        assert np.isfinite(t["reward"]) and t["finite"] and t["grad_steps"] == 8
        assert t["size"] == 4 * 2 * 16 // 2  # rounds * T * B / n shards


def test_shard_local_insert_keeps_rows_on_their_shard():
    """After a local insert on an 8-shard logical mesh, shard d's block holds
    exactly shard d's envs' transitions in step-major order."""
    mesh = make_env_mesh(n_shards=8)
    n, T, B, cap, dim = 8, 2, 16, 64, 3
    local_b, local_cap = B // n, cap // n
    obs = torch.arange(T * B * dim, dtype=torch.float32).reshape(T, B, dim)
    traj = dict(obs=obs, action=torch.zeros(T, B, 2), reward=torch.zeros(T, B), next_obs=obs,
                done=torch.zeros(T, B))
    buf = buffer_add_traj_local(buffer_init(cap, dim, 2), traj, mesh)
    assert buf.size == T * local_b and buf.blocks == n  # LOCAL rows
    for d in range(n):
        for t in range(T):
            for b in range(local_b):
                assert torch.equal(buf.obs[d * local_cap + t * local_b + b], obs[t, d * local_b + b])


def test_shard_local_sampling_is_uniform_over_shards_and_rows():
    """Stratified local sampling: every batch takes batch/n rows from each
    shard, and within a shard the rows are uniform over the local fill."""
    mesh = make_env_mesh(n_shards=8)
    n, cap, T, B = 8, 256, 2, 16
    buf = buffer_init(cap, 1, 1)
    for i in range(cap // n // (T * B // n)):
        base = torch.arange(T * B, dtype=torch.float32) + i * T * B
        traj = dict(obs=base.reshape(T, B, 1), action=torch.zeros(T, B, 1), reward=torch.zeros(T, B),
                    next_obs=torch.zeros(T, B, 1), done=torch.zeros(T, B))
        buffer_add_traj_local(buf, traj, mesh)
    assert buf.size == cap // n  # locally full
    batch_size, local_cap, draws = 64, cap // n, 200
    counts = np.zeros(cap)
    for s in range(draws):
        got = buffer_sample_local(buf, batch_size, mesh, seed=s)["obs"]
        assert got.shape == (batch_size, 1)
        for v in got[:, 0].tolist():
            t, b = divmod(int(v), B)
            t_outer, t_inner = divmod(t, T)
            d, b_local = divmod(b, B // n)
            counts[d * local_cap + t_outer * (T * B // n) + t_inner * (B // n) + b_local] += 1
        # shard-major: rows [s*bs/n, (s+1)*bs/n) of the batch come from shard s
        shards = [divmod(divmod(int(v), B)[1], B // n)[0] for v in got[:, 0].tolist()]
        assert shards == sorted(shards)
    np.testing.assert_array_equal(counts.reshape(n, local_cap).sum(1), np.full(n, draws * batch_size // n))
    expected = draws * batch_size / cap
    assert counts.min() > 0.3 * expected and counts.max() < 3.0 * expected


def test_learner_refuses_an_unsharded_state_on_ranks_and_mismatched_blocks():
    mesh2 = make_env_mesh(n_shards=2)
    learner = SacLearner(make("usv-simple", device="cpu"), SacConfig(**SAC, shard_local_replay=True),
                         mesh=mesh2)
    ts = learner.init(0)
    assert ts.buffer.blocks == 2
    ts.buffer = buffer_reshard_local(ts.buffer, 2, 4)
    with pytest.raises(ValueError, match="buffer_reshard_local"):
        learner.train_rounds(ts, 1)
    with pytest.raises(ValueError, match="sharded already"):
        shard_sac_train_state(shard_sac_train_state(learner.init(0), mesh2), mesh2)


def test_graft_entry_dryrun():
    out = dryrun_multichip(2, device="cpu")
    assert [r["grad_steps"] for r in out] == [4, 4] and [r["update_count"] for r in out] == [1, 1]
    assert all(r["backend"] == "gloo" and r["collectives"] > 0 for r in out)


def test_dryrun_refuses_nccl_on_shared_cards_and_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_distributed("127.0.0.1:1", 2, 0)
    assert initialize_distributed(num_processes=1) is False  # a one-process cluster: a no-op
    with pytest.raises(ValueError, match="form a cluster"):
        initialize_distributed("127.0.0.1:1", 2)


# ----------------------------------------------------------- against JAX's


def _jax_buffer_pair(cap, obs_dim, act_dim, rows=None):
    import jax.numpy as jnp

    from usv_tpu.train.buffer import buffer_init as jbuffer_init

    jbuf = jbuffer_init(cap, obs_dim, act_dim)
    buf = buffer_init(cap, obs_dim, act_dim)
    if rows is not None:
        jbuf = jbuf.replace(**{f: jnp.asarray(v) for f, v in rows.items()})
        for f, v in rows.items():
            getattr(buf, f).copy_(torch.from_numpy(v))
    return jbuf, buf


def _random_traj(rng, T, B, obs_dim, act_dim):
    return dict(obs=rng.standard_normal((T, B, obs_dim)).astype(np.float32),
                action=rng.uniform(-1, 1, (T, B, act_dim)).astype(np.float32),
                reward=rng.standard_normal((T, B)).astype(np.float32),
                next_obs=rng.standard_normal((T, B, obs_dim)).astype(np.float32),
                done=(rng.random((T, B)) < 0.2).astype(np.float32))


def test_shard_local_insert_sample_and_reshard_match_jax():
    """On the same numpy data: JAX's insert on its 8-device mesh against the
    port's on an 8-shard logical mesh, three inserts deep (a wrap included);
    the sample with JAX's per-shard indices (``fold_in(key, shard)``)
    injected; the re-layout to 4, 2 and 1 blocks and its refusals. Bit for
    bit."""
    import jax
    import jax.numpy as jnp

    from usv_tpu.parallel.mesh import make_env_mesh as jmake_env_mesh
    from usv_tpu.train import buffer as jbuffer

    jmesh, mesh = jmake_env_mesh(), make_env_mesh(n_shards=8)
    rng = np.random.default_rng(0)
    T, B, obs_dim, act_dim, cap = 2, 16, 5, 2, 64  # local block 8: a wrap on the 5th insert
    jinsert = jax.jit(lambda b, t: jbuffer.buffer_add_traj_local(b, t, jmesh))
    jbuf, buf = _jax_buffer_pair(cap, obs_dim, act_dim)
    for _ in range(5):
        traj = _random_traj(rng, T, B, obs_dim, act_dim)
        jbuf = jinsert(jbuf, {k: jnp.asarray(v) for k, v in traj.items()})
        buffer_add_traj_local(buf, {k: torch.from_numpy(v) for k, v in traj.items()}, mesh)
        assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
        for f in ReplayBuffer.FIELDS:
            np.testing.assert_array_equal(getattr(buf, f).numpy(), np.asarray(getattr(jbuf, f)), err_msg=f)

    key, bs = jax.random.key(7), 32
    want = jbuffer.buffer_sample_local(jbuf, key, bs, jmesh)
    idx = torch.stack([torch.from_numpy(np.array(jax.random.randint(
        jax.random.fold_in(key, s), (bs // 8,), 0, jnp.maximum(jbuf.size, 1)))).long() for s in range(8)])
    got = buffer_sample_local(buf, bs, mesh, idx=idx)
    for f in ReplayBuffer.FIELDS:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]), err_msg=f)

    for n_dst, insert_rows in ((4, None), (2, 16), (1, 32)):
        want = jbuffer.buffer_reshard_local(jbuf, 8, n_dst, insert_rows=insert_rows)
        got = buffer_reshard_local(buf, 8, n_dst, insert_rows=insert_rows)
        assert (got.ptr, got.size, got.blocks) == (int(want.ptr), int(want.size), n_dst)
        for f in ReplayBuffer.FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    # a part-filled buffer, and the refusals, on both sides
    jpart, part = _jax_buffer_pair(cap, obs_dim, act_dim)
    traj = _random_traj(rng, T, B, obs_dim, act_dim)
    jpart = jinsert(jpart, {k: jnp.asarray(v) for k, v in traj.items()})
    buffer_add_traj_local(part, {k: torch.from_numpy(v) for k, v in traj.items()}, mesh)
    for args in ((8, 4, None), (8, 3, None), (7, 2, None), (8, 4, 3)):
        try:
            want = jbuffer.buffer_reshard_local(jpart, args[0], args[1], insert_rows=args[2])
        except ValueError as e:
            with pytest.raises(ValueError) as exc:
                buffer_reshard_local(part, args[0], args[1], insert_rows=args[2])
            assert str(exc.value) == str(e)
            continue
        got = buffer_reshard_local(part, args[0], args[1], insert_rows=args[2])
        assert (got.ptr, got.size) == (int(want.ptr), int(want.size)), args
        for f in ReplayBuffer.FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_shard_local_sac_round_matches_jax():
    """One shard-local SAC round of the port's 8-shard logical learner
    against JAX's shard-local learner on its 8-device mesh, from the same
    state, with JAX's collect draws and (per shard) replay indices and
    update noise injected: the collected rows at 2e-4, the first update's
    gradients at 2e-6 of the largest entry (on the same replay rows), its
    parameters as ``tests/test_torch_sac.py`` holds one update."""
    import jax
    import jax.numpy as jnp
    import optax

    import test_torch_sac as ts_helpers
    from usv_tpu import envs as jenvs
    from usv_tpu.parallel.mesh import make_env_mesh as jmake_env_mesh
    from usv_tpu.train import sac as jsac
    from usv_tpu.train.buffer import buffer_sample_local as jbuffer_sample_local

    cfg = dict(ts_helpers.SMALL, learning_starts=0)
    jmesh, mesh = jmake_env_mesh(), make_env_mesh(n_shards=8)
    jl = jsac.SacLearner(jenvs.make("usv-simple"), jsac.SacConfig(**cfg, shard_local_replay=True), mesh=jmesh)
    jts = jl.init(seed=0)
    tl = SacLearner(make("usv-simple", device="cpu"), SacConfig(**cfg, shard_local_replay=True), mesh=mesh)
    ts = ts_helpers.torch_state(tl, jts)
    assert ts.buffer.blocks == 8
    T = cfg["train_freq"]
    _, k_collect, k_update = jax.random.split(jts.key, 3)
    draws = ts_helpers.collect_draws(jl, k_collect, jts.env_state.key, tl.handle.n_uniform(tl.handle.cfg), T)
    jmid, jreward = jax.jit(jl._env_cycle)(jts, k_collect)
    ts, reward = tl._env_cycle(ts, draws)
    assert (ts.buffer.ptr, ts.buffer.size) == (int(jmid.buffer.ptr), int(jmid.buffer.size)) == (T, T)
    for f in ("obs", "action", "reward", "next_obs"):
        np.testing.assert_allclose(getattr(ts.buffer, f).numpy(), np.asarray(getattr(jmid.buffer, f)),
                                   atol=2e-4, rtol=0, err_msg=f)
    np.testing.assert_array_equal(ts.buffer.done.numpy(), np.asarray(jmid.buffer.done))
    assert float(reward) == pytest.approx(float(jreward), abs=2e-4 * T * cfg["num_envs"])

    # the update on the same replay rows: JAX's buffer into the port's
    with torch.no_grad():
        for f in ReplayBuffer.FIELDS:
            getattr(ts.buffer, f).copy_(torch.from_numpy(np.array(getattr(jmid.buffer, f))))
    bs = cfg["batch_size"]
    key = jax.random.split(k_update, cfg["gradient_steps"])[0]
    d, (k_batch, k_critic, k_actor) = ts_helpers.update_draws(jmid, key, bs, tl.obs_dim)
    d["idx"] = torch.from_numpy(np.array(jax.jit(lambda k, size: jnp.stack([jax.random.randint(
        jax.random.fold_in(k, s), (bs // 8,), 0, jnp.maximum(size, 1)) for s in range(8)]))(
        k_batch, jmid.buffer.size))).long()
    jbatch = jbuffer_sample_local(jmid.buffer, k_batch, bs, jmesh)
    batch = buffer_sample_local(ts.buffer, bs, mesh, idx=d["idx"])
    for f in ReplayBuffer.FIELDS:
        np.testing.assert_array_equal(batch[f].numpy(), np.asarray(jbatch[f]), err_msg=f)
    # JAX's update, step by step (jl._update_once's order) on one device
    @jax.jit
    def jax_update(jmid, jbatch):
        jcritic = jax.grad(jl._critic_loss)(jmid.critic_params, jmid, jbatch, k_critic)
        upd, _ = jl.critic_tx.update(jcritic, jmid.critic_opt, jmid.critic_params)
        jnext = jmid.replace(critic_params=optax.apply_updates(jmid.critic_params, upd))
        jactor = jax.grad(lambda p: jl._actor_loss(p, jnext, jbatch, k_actor)[0])(jmid.actor_params)
        upd, _ = jl.actor_tx.update(jactor, jmid.actor_opt, jmid.actor_params)
        return jcritic, jnext, jactor, optax.apply_updates(jmid.actor_params, upd)

    jcritic, jnext, jactor, jactor_params = jax_update(
        jmid, {k: jnp.asarray(np.asarray(v)) for k, v in jbatch.items()})
    trace = {}
    tl._update_once(ts, bs, draws=d, trace=trace)
    for module, grads, jgrads, jparams in (
            (ts.critic, trace["critic"], jcritic, jnext.critic_params),
            (ts.actor, trace["actor"], jactor, jactor_params)):
        names = [n for n, _ in module.named_parameters()]
        ts_helpers.assert_grads(dict(zip(names, grads)), jgrads, 2e-6, type(module).__name__)
        # one Adam step: 2e-7 where the gradient is firm, else up to 2 x lr
        ref, g = ts_helpers.torch_tree(jparams), ts_helpers.torch_tree(jgrads)
        lr = tl.cfg.learning_rate
        for name, value in module.state_dict().items():
            err = (value - ref[name]).abs()
            assert float(torch.where(g[name].abs() > 1e-4, err, 0.0).max()) <= 2e-7, name
            assert float(err.max()) <= 2 * lr + 2e-7, name

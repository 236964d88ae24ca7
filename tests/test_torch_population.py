"""Seed populations in the port (the learners' ``*_many`` methods,
``train/population.py`` and ``--recipe robust``), on the CPU.

* Member ``i`` of a population is the single-seed learner seeded
  ``seeds[i]``: SAC and PPO at S = 2, and a population of one. Bit for bit
  where the computation is elementwise: the initial weights, env states,
  gSDE matrices and generator states, every draw, and the rows of the first
  collect (SAC's is all warm-up, so no network acts in it). The first
  update's losses and gradients at 2e-6 relative to the largest entry (the
  members' products are batched GEMMs through ``vmap``, the single learner's
  ``addmm``: they may round differently), the parameters after it within
  ``2 * lr`` (Adam's first step is ``lr * sign(g)`` where ``|g|`` is tiny),
  and obs and reward after three rounds or iterations at 2e-4 (ROADMAP's
  multi-step bound).
* PPO clips every member's gradient by that member's own global norm.
* A cull keeps everything of the kept members: continuing after the cull
  gives what continuing the whole population gives for them.
* ``run_population_loop`` and ``select_and_export_winner`` make the same
  culls, the same winner and the same selection table as ``usv_tpu``'s, fed
  the same stub training and the same stub eval stats.
* Both CLIs with ``--recipe robust`` end to end at tiny sizes with
  ``--device cpu``; the winner's recorded selection eval replays exactly.
"""

import argparse
import dataclasses
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")

from usv_tpu.train import population as jpop  # noqa: E402
from usv_tpu.train import run_ppo as jrun_ppo  # noqa: E402
from usv_tpu.train import run_sac as jrun_sac  # noqa: E402
from usv_tpu_torch.envs import make  # noqa: E402
from usv_tpu_torch.envs.types import tree_leaves  # noqa: E402
from usv_tpu_torch.train import population as tpop  # noqa: E402
from usv_tpu_torch.train import run_eval, run_ppo, run_sac  # noqa: E402
from usv_tpu_torch.train.buffer import ReplayBuffer, buffer_sample, buffer_sample_many  # noqa: E402
from usv_tpu_torch.train.common import clip_by_global_norm, clip_by_global_norm_many  # noqa: E402
from usv_tpu_torch.train.ppo import PpoConfig, PpoLearner  # noqa: E402
from usv_tpu_torch.train.sac import SacConfig, SacLearner  # noqa: E402

SAC_SMALL = dict(buffer_size=512, batch_size=32, learning_starts=32, num_envs=8, train_freq=4,
                 gradient_steps=2, hidden=(32, 32), frame_stack=2)
PPO_SMALL = dict(n_steps=8, batch_size=16, n_epochs=2, num_envs=4, pi_hidden=(32, 32),
                 vf_hidden=(32, 32), frame_stack=2)
GRAD_RTOL = 2e-6
DRIFT = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: pytest-xdist may run several test processes on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sac_learner(**over):
    return SacLearner(make("usv-simple", device="cpu"), SacConfig(**{**SAC_SMALL, **over}))


def ppo_learner(env_id="usv-simple", **over):
    return PpoLearner(make(env_id, device="cpu"), PpoConfig(**{**PPO_SMALL, **over}))


def rows(x, i, block):
    return x[i * block:(i + 1) * block]


def same_rows(pop_tree, single_tree, i, block):
    """Member ``i``'s rows of every leaf of a member-major tree equal the
    single learner's leaves, bit for bit."""
    for a, b in zip(tree_leaves(pop_tree), tree_leaves(single_tree)):
        assert torch.equal(rows(a, i, block), b)


def member_params_equal(stacked, module, i):
    return all(torch.equal(p[i], q) for p, q in zip(stacked.params, module.parameters()))


def assert_grads_close(got, want):
    scale = max(float(w.abs().max()) for w in want)
    diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert diff <= GRAD_RTOL * scale, f"gradients {diff} apart, largest entry {scale}"


def params_within(stacked, module, i, bound):
    diff = max(float((p[i].detach() - q.detach()).abs().max())
               for p, q in zip(stacked.params, module.parameters()))
    assert diff <= bound, diff


@pytest.mark.parametrize("seeds,member", [([10, 11], 1), ([11], 0)], ids=["S=2", "S=1"])
def test_sac_member_matches_single_learner(seeds, member):
    learner = sac_learner()
    B, bs = learner.cfg.num_envs, learner.cfg.batch_size
    ps, ts = learner.init_many(seeds), learner.init(seeds[member])
    assert member_params_equal(ps.actor, ts.actor, member) and member_params_equal(ps.critic, ts.critic, member)
    same_rows(ps.batch, ts.batch, member, B)
    same_rows(ps.sde, ts.sde, member, B)
    assert torch.equal(ps.generators[member].get_state(), ts.generator.get_state())

    # the first cycle is warm-up (learning_starts 32 = 4 steps of 8 envs):
    # uniform actions, no network, every row equal
    learner._env_cycle_many(ps)
    learner._env_cycle(ts)
    same_rows(ps.batch, ts.batch, member, B)
    for f in ReplayBuffer.FIELDS:
        assert torch.equal(getattr(ps.buffer, f)[member], getattr(ts.buffer, f))
    assert torch.equal(ps.generators[member].get_state(), ts.generator.get_state())

    # the first update: the same draws, losses and gradients at 2e-6
    draws = learner._update_draws_many(ps, bs)
    d = learner._update_draws(ts, bs, ts.generator)
    assert all(torch.equal(draws[k][member], d[k]) for k in d)
    pbatch = buffer_sample_many(ps.buffer, draws["idx"])
    single_batch = buffer_sample(ts.buffer, bs, idx=d["idx"])
    assert all(torch.equal(pbatch[k][member], single_batch[k]) for k in single_batch)
    closs = learner._critic_loss_many(ps, pbatch, draws["noise_next"])
    want = learner._critic_loss(ts, single_batch, d["noise_next"])
    assert abs(float(closs[member].detach() - want.detach())) <= GRAD_RTOL * abs(float(want.detach()))
    got = [g[member] for g in torch.autograd.grad(closs.sum(), ps.critic.params)]
    assert_grads_close(got, torch.autograd.grad(want, list(ts.critic.parameters())))
    aloss, _ = learner._actor_loss_many(ps, pbatch, draws["noise_actor"], draws["noise_spatial"])
    want, _ = learner._actor_loss(ts, single_batch, d["noise_actor"], d["noise_spatial"])
    assert abs(float(aloss[member].detach() - want.detach())) <= GRAD_RTOL * abs(float(want.detach()))
    got = [g[member] for g in torch.autograd.grad(aloss.sum(), ps.actor.params)]
    assert_grads_close(got, torch.autograd.grad(want, list(ts.actor.parameters())))

    learner._update_once_many(ps, draws=draws)
    learner._update_once(ts, draws=d)
    lr = learner.lr_at(0)
    for name in ("actor", "critic", "target_critic"):
        params_within(getattr(ps, name), getattr(ts, name), member, 2 * lr)
    assert abs(float((ps.log_alpha[member] - ts.log_alpha).detach())) <= 2 * lr

    # three more rounds (each updates): obs and reward at the drift bound
    learner.train_rounds_many(ps, 3)
    learner.train_rounds(ts, 3)
    assert ps.env_steps == ts.env_steps and ps.grad_steps == ts.grad_steps and ps.buffer.size == ts.buffer.size
    np.testing.assert_allclose(rows(ps.batch.frames, member, B), ts.batch.frames, atol=DRIFT, rtol=0)
    np.testing.assert_allclose(ps.buffer.reward[member], ts.buffer.reward, atol=DRIFT, rtol=0)

    stats = learner.eval_policy_stats_many(ps, n_steps=12, num_envs=3)
    want = learner.eval_policy_stats(ts, n_steps=12, num_envs=3)
    assert learner.eval_seeds(ps)[member] == learner.eval_seed(ts)
    assert set(stats) == set(want) and all(v.shape == (len(seeds),) for v in stats.values())
    for k, v in want.items():
        assert stats[k][member] == pytest.approx(v, abs=DRIFT)


@pytest.mark.parametrize("seeds,member", [([20, 21], 1), ([21], 0)], ids=["S=2", "S=1"])
def test_ppo_member_matches_single_learner(seeds, member):
    learner = ppo_learner()
    B = learner.cfg.num_envs
    ps, ts = learner.init_many(seeds), learner.init(seeds[member])
    assert member_params_equal(ps.model, ts.model, member)
    same_rows(ps.batch, ts.batch, member, B)
    same_rows(ps.sde, ts.sde, member, B)

    ps, traj, last = learner._collect_many(ps)
    ts, straj, slast = learner._collect(ts)
    assert torch.equal(ps.generators[member].get_state(), ts.generator.get_state())
    for k in traj:
        np.testing.assert_allclose(traj[k][:, member * B:(member + 1) * B], straj[k], atol=1e-6, rtol=0)
    np.testing.assert_allclose(rows(last, member, B), slast, atol=1e-6, rtol=0)

    # the first minibatch under each side's own (equal) permutation draws
    state = ps.generators[member].get_state()
    advs, rets = learner._gae(traj, last, learner.cfg.gamma, learner.cfg.gae_lambda)
    draw, batches, _ = learner._minibatches_many(ps, traj, advs, rets)
    mb = {k: v[:, 0] for k, v in batches(draw()).items()}
    sadvs, srets = learner._gae(straj, slast, learner.cfg.gamma, learner.cfg.gae_lambda)
    sdraw, sbatches, _ = learner._minibatches(straj, sadvs, srets)
    smb = {k: v[0] for k, v in sbatches(sdraw(ts.generator)).items()}
    for k in smb:
        np.testing.assert_allclose(mb[k][member], smb[k], atol=1e-5, rtol=1e-6)
    cfg = learner.cfg
    loss = learner._loss_many(ps, mb)
    want = learner._loss(ts.model, smb, cfg.clip_range, cfg.ent_coef, cfg.vf_coef)
    assert abs(float(loss[member].detach() - want.detach())) <= GRAD_RTOL * max(1.0, abs(float(want.detach())))
    got = [g[member] for g in torch.autograd.grad(loss.sum(), ps.model.params)]
    assert_grads_close(got, torch.autograd.grad(want, list(ts.model.parameters())))
    ps.generators[member].set_state(state)  # the update draws its shuffles anew
    ts.generator.set_state(state)

    learner._update_many(ps, traj, last)
    learner._update(ts, straj, slast)
    assert ps.opt_steps == ts.opt_steps
    for _ in range(2):
        ps, reward = learner.train_iteration_many(ps)
        ts, sreward = learner.train_iteration(ts)
        assert float(reward[member]) == pytest.approx(float(sreward), abs=DRIFT)
    np.testing.assert_allclose(rows(ps.batch.frames, member, B), ts.batch.frames, atol=DRIFT, rtol=0)

    stats = learner.eval_policy_stats_many(ps, n_steps=10, num_envs=3)
    want = learner.eval_policy_stats(ts, n_steps=10, num_envs=3)
    assert learner.eval_seeds(ps)[member] == learner.eval_seed(ts)
    for k, v in want.items():
        assert stats[k][member] == pytest.approx(v, abs=DRIFT)


def test_ppo_clips_each_member_by_its_own_norm():
    """One member's gradient under ``max_grad_norm``, the other's over it:
    the first stays as it is, the second is scaled to the bound; a clip by
    the population's norm (the bug) would scale both."""
    learner = ppo_learner()
    ps = learner.init_many([0, 1])
    ps, traj, last = learner._collect_many(ps)
    advs, rets = learner._gae(traj, last, learner.cfg.gamma, learner.cfg.gae_lambda)
    draw, batches, _ = learner._minibatches_many(ps, traj, advs, rets)
    mb = {k: v[:, 0] for k, v in batches(draw()).items()}
    grads = torch.autograd.grad(learner._loss_many(ps, mb).sum(), ps.model.params)
    norms = torch.sqrt(sum(g.square().flatten(1).sum(1) for g in grads))
    lo, hi = sorted(norms.tolist())
    assert hi > 1.2 * lo, norms
    bound = (lo + hi) / 2
    small, big = int(norms.argmin()), int(norms.argmax())
    clipped = clip_by_global_norm_many(grads, bound)
    assert all(torch.equal(c[small], g[small]) for c, g in zip(clipped, grads))
    alone = clip_by_global_norm([g[big] for g in grads], bound)
    assert all(torch.allclose(c[big], a, rtol=1e-6, atol=0) for c, a in zip(clipped, alone))
    norm_big = torch.sqrt(sum(c[big].square().sum() for c in clipped))
    assert float(norm_big) == pytest.approx(bound, rel=1e-5)
    whole = clip_by_global_norm(grads, bound)  # one norm over the population
    assert not torch.equal(whole[0][small], grads[0][small])

    # and the learner's step takes the per-member path
    stepped = dataclasses.replace(learner.cfg, max_grad_norm=bound)
    learner.cfg = stepped
    before = [p.detach().clone() for p in ps.model.params]
    learner._minibatch_step_many(ps, mb)
    assert all(not torch.equal(p, b) for p, b in zip(ps.model.params, before))


def _stacked_state(ps, names):
    out = []
    for name in names:
        value = getattr(ps, name)
        out.append(value.params if hasattr(value, "params") else value)
    return out


@pytest.mark.parametrize("kind", ["sac", "ppo"])
def test_cull_keeps_what_the_kept_members_carry(kind):
    """Two equal populations of three: one is culled to members 0 and 2,
    both go on; the culled one's members are the other's members 0 and 2 —
    parameters, optimizer moments, temperatures, replay rows, env rows,
    frames, gSDE state and generators."""
    if kind == "sac":
        learner = sac_learner(learning_starts=8)
        run = lambda p: learner.train_rounds_many(p, 2)  # noqa: E731
    else:
        learner = ppo_learner("usv-asmc-ca-v0", use_sde=False, shuffle_groups=2,
                              shuffle_group_rotate=True)
        run = learner.train_iteration_many
    B = learner.cfg.num_envs
    a, b = learner.init_many([5, 6, 7]), learner.init_many([5, 6, 7])
    a, _ = run(a)
    b, _ = run(b)
    a = learner.take_members(a, [0, 2])
    assert a.seeds == [5, 7]
    a, _ = run(a)
    b, _ = run(b)
    keep = torch.tensor([0, 2])

    def close(x, y):
        np.testing.assert_allclose(x.detach(), y.detach(), atol=1e-6, rtol=0)

    nets = ("actor", "critic", "target_critic") if kind == "sac" else ("model",)
    for name in nets:
        for p, q in zip(getattr(a, name).params, getattr(b, name).params):
            close(p, q.index_select(0, keep))
    opts = ("actor_opt", "critic_opt", "alpha_opt") if kind == "sac" else ("opt",)
    for name in opts:
        oa, ob = getattr(a, name), getattr(b, name)
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            for k in ("exp_avg", "exp_avg_sq"):
                close(oa.state[pa][k], ob.state[pb][k].index_select(0, keep))
            assert float(oa.state[pa]["step"]) == float(ob.state[pb]["step"])
    if kind == "sac":
        close(a.log_alpha, b.log_alpha.index_select(0, keep))
        for f in ReplayBuffer.FIELDS:
            close(getattr(a.buffer, f), getattr(b.buffer, f).index_select(0, keep))
    for j, i in enumerate((0, 2)):
        assert torch.equal(a.generators[j].get_state(), b.generators[i].get_state())
        for x, y in zip(tree_leaves(a.batch), tree_leaves(b.batch)):
            if x.is_floating_point():
                close(rows(x, j, B), rows(y, i, B))
            else:
                assert torch.equal(rows(x, j, B), rows(y, i, B))


class StubLearner:
    """What the population loop asks of a learner, with eval stats from a
    table: ``stats[unit][seed]`` in training, ``select[seed][es]`` in the
    selection. The same stub serves both packages: ``ts`` is the array of the
    live seeds, a member's parameters are its seed."""

    def __init__(self, stats, select, torch_side):
        self.stats, self.select, self.torch_side = stats, select, torch_side
        self.unit = 0

    def train_many(self, ts):
        self.unit += 1
        return ts, dict(mean_reward=0.25 * self.unit)

    def eval_policy_stats_many(self, ts, n_steps, num_envs):
        seeds = ts.seeds if self.torch_side else np.asarray(ts)
        return {"reward_per_step": np.array([self.stats[self.unit][int(s)] for s in seeds], np.float32),
                "episodes": np.array([2.0 * int(s) for s in seeds], np.float32)}

    def take_members(self, ts, keep):
        return types.SimpleNamespace(seeds=[ts.seeds[i] for i in keep])

    def module_from(self, params):
        return int(params["seed"])

    def eval_policy_stats_at(self, params, seed_or_key, n_steps, num_envs):
        if self.torch_side:
            es = seed_or_key - tpop.SELECT_SEED
        else:
            es = int(jax.random.key_data(seed_or_key)[-1]) - 100_000
            params = int(params)
        return {"reward_per_step": self.select[params][es], "episodes": float(es)}


class StubStacked:
    def __init__(self, seeds):
        self.seeds = seeds

    def member(self, i):
        return {"seed": torch.tensor(self.seeds[i])}


LOOP_CASES = {
    # four seeds, evals every unit, a cull at half the budget to two
    "cull": dict(units=4, eval_every=1, cull_at_frac=0.5, cull_keep=None,
                 stats={1: {0: 0.1, 1: 0.5, 2: 0.3, 3: -0.2}, 2: {0: 0.2, 1: 0.4, 2: 0.6, 3: 0.0},
                        3: {1: 0.9, 2: 0.1}, 4: {1: 0.2, 2: 0.7}},
                 select={1: [0.3, 0.5], 2: [0.6, 0.1]}),
    # no eval in the run: the candidates are the final parameters
    "no-eval": dict(units=2, eval_every=0, cull_at_frac=0.0, cull_keep=None, stats={},
                    select={0: [0.2, 0.2], 1: [0.1, 0.4], 2: [0.5, -1.0], 3: [0.0, 0.0]}),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_population_loop_and_selection_match_jax(case, tmp_path, capsys, monkeypatch):
    c = LOOP_CASES[case]
    seeds = [0, 1, 2, 3]
    runs = {}
    for side, mod in (("jax", jpop), ("torch", tpop)):
        exports = []

        def export(learner, state, path, extra_meta=None, exports=exports):
            params = state.params if hasattr(state, "params") else state.actor  # JAX's, the port's
            exports.append((path.rsplit("/", 1)[-1], int(np.asarray(params)),
                            (extra_meta or {}).get("population")))

        monkeypatch.setattr(mod, "export_policy", export)
        learner = StubLearner(c["stats"], c["select"], side == "torch")
        args = argparse.Namespace(
            resume=False, logdir=str(tmp_path / side), population=4, cull_at_frac=c["cull_at_frac"],
            cull_keep=c["cull_keep"], eval_steps=8, eval_envs=2, best_metric="reward",
            select_evals=2, recipe="robust", env="usv-simple")
        if side == "torch":
            ts = types.SimpleNamespace(seeds=list(seeds))
            params_of = lambda t: StubStacked(t.seeds)  # noqa: E731
        else:
            ts = np.asarray(seeds)
            params_of = lambda t: t  # noqa: E731
        mod.run_population_loop(learner, list(seeds), ts, args, train_many=learner.train_many,
                                total_units=c["units"], steps_per_unit=64, eval_every=c["eval_every"],
                                params_of=params_of)
        out = capsys.readouterr().out
        lines = [json.loads(x) for x in (tmp_path / side / "metrics.jsonl").read_text().splitlines()]
        logged = [{k: v for k, v in x.items() if k not in ("aggregate_steps_per_second", "wall_s")}
                  for x in lines]
        culls = [x for x in out.splitlines() if "culled_seeds" in x]
        runs[side] = dict(exports=exports, logged=logged,
                          culls=[x.split("'culled_seeds': ")[1].split("]")[0] for x in culls])
    assert runs["torch"] == runs["jax"]
    pop = runs["torch"]["exports"][0][2]
    assert [e[0] for e in runs["torch"]["exports"]] == ["policy_best", "policy"]
    sel = {s["seed"]: s["select_mean"] for s in pop["selection"]}
    assert sel[pop["winner_seed"]] == max(sel.values())
    assert len(pop["selection"]) == (2 if case == "cull" else 4)


def test_ppo_robust_recipe_end_to_end(tmp_path):
    logdir = tmp_path / "ppo"
    learner, ps = run_ppo.main([
        "--recipe", "robust", "--env", "usv-simple", "--population", "3",
        "--total-steps", "768", "--num-envs", "4", "--n-steps", "32",
        "--batch-size", "64", "--update-fusion", "1",
        "--eval-every-iters", "2", "--eval-steps", "16", "--eval-envs", "4",
        "--cull-at-frac", "0.5", "--cull-keep", "2", "--select-evals", "2",
        "--checkpoint-every-iters", "0", "--logdir", str(logdir), "--device", "cpu",
    ])
    assert len(ps.seeds) == 2 and ps.update_count == 6
    meta = json.loads((logdir / "policy_best" / "policy.json").read_text())
    pop = meta["population"]
    assert pop["recipe"] == "robust" and pop["seeds"] == ps.seeds
    assert len(pop["selection"]) == 2, "cull should leave 2 candidates"
    sel = {s["seed"]: s["select_mean"] for s in pop["selection"]}
    assert sel[pop["winner_seed"]] == max(sel.values()), "winner = argmax"
    assert meta["in_run_eval"]["seed"] == tpop.SELECT_SEED
    assert (logdir / "policy" / "policy.json").exists(), "final export too"

    out = tmp_path / "replay"
    run_eval.main(["--env", "usv-simple", "--policy", str(logdir / "policy_best"), "--out", str(out),
                   "--replay-recorded-eval", "--steps", "4", "--episodes", "2", "--device", "cpu"])
    assert json.loads((out / "replay_recorded_eval.json").read_text())["exact_match"]


def test_sac_robust_recipe_end_to_end(tmp_path, capsys):
    logdir = tmp_path / "sac"
    learner, ps = run_sac.main([
        "--recipe", "robust", "--env", "usv-simple", "--population", "2",
        "--total-steps", "1024", "--num-envs", "8", "--train-freq", "8",
        "--gradient-steps", "2", "--update-fusion", "1",
        "--buffer-size", "1000", "--learning-starts", "128",
        "--batch-size", "32", "--rounds-per-block", "4",
        "--eval-every-blocks", "2", "--eval-steps", "16", "--eval-envs", "4",
        "--select-evals", "2", "--checkpoint-every-blocks", "0",
        "--logdir", str(logdir), "--device", "cpu",
    ])
    # per-member capacity rounded up to the 64-row write block
    assert learner.buffer_capacity == 1024 and ps.buffer.obs.shape[:2] == (2, 1024)
    assert f"population replay: 2 seeds x 1024 rows, {ps.buffer.nbytes()} bytes" in capsys.readouterr().out
    meta = json.loads((logdir / "policy_best" / "policy.json").read_text())
    assert meta["kind"] == "sac"
    pop = meta["population"]
    assert len(pop["selection"]) == 2 and pop["winner_seed"] in pop["seeds"]
    assert meta["in_run_eval"]["seed"] == tpop.SELECT_SEED
    out = tmp_path / "replay"
    run_eval.main(["--env", "usv-simple", "--policy", str(logdir / "policy_best"), "--out", str(out),
                   "--replay-recorded-eval", "--steps", "4", "--episodes", "2", "--device", "cpu"])
    assert json.loads((out / "replay_recorded_eval.json").read_text())["exact_match"]


def test_robust_recipe_defaults_resolve():
    """--recipe robust inherits the at-scale hyperparameters and defaults to
    a 4-seed population, as the JAX CLIs resolve it; explicit flags win."""
    for argv in (["--recipe", "robust"], ["--recipe", "robust", "--population", "6", "--num-envs", "64"]):
        got = run_ppo.apply_recipe(run_ppo.build_parser().parse_args(argv))
        jp = jrun_ppo.build_parser()
        want = jrun_ppo.apply_recipe(jp.parse_args(argv), jp)
        for k in ("population", "num_envs", "batch_size", "update_fusion", "single_shuffle",
                  "lr_decay_updates", "eval_steps"):
            assert getattr(got, k) == getattr(want, k), k
    args = run_ppo.apply_recipe(run_ppo.build_parser().parse_args(["--recipe", "robust"]))
    assert args.population == 4 and args.num_envs == 256 and args.batch_size == 2048
    sac = run_sac.apply_recipe(run_sac.build_parser().parse_args(["--recipe", "robust"]))
    want = jrun_sac.apply_recipe(argparse.Namespace(
        recipe="robust", num_envs=None, train_freq=None, gradient_steps=None, update_fusion=None,
        lr=None, population=None, buffer_size=None))
    assert (sac.population, sac.num_envs, sac.buffer_size) == (want.population, want.num_envs,
                                                             want.buffer_size) == (4, 1024, 100_000)


def test_population_mode_surfaces_unsupported_flags(tmp_path, capsys):
    """Population runs have no checkpoint/resume machinery: --resume refuses
    (it does not train from scratch) and nonzero checkpoint/video cadences
    the user set are announced as ignored."""
    learner = ppo_learner(n_epochs=1, pi_hidden=(16, 16), vf_hidden=(16, 16), frame_stack=1)
    seeds = [0, 1]
    ts = learner.init_many(seeds)

    def mk_args(**over):
        base = dict(resume=False, checkpoint_every_iters=0, video_every_iters=0,
                    logdir=str(tmp_path / "pop"), population=2, cull_at_frac=0.0, cull_keep=None,
                    eval_steps=20, eval_envs=2, best_metric="reward", select_evals=1,
                    recipe="robust", env="usv-simple", seed=0)
        base.update(over)
        return argparse.Namespace(**base)

    with pytest.raises(SystemExit, match="resume"):
        tpop.run_population_loop(learner, seeds, ts, mk_args(resume=True),
                                 train_many=lambda t: (t, {}), total_units=1, steps_per_unit=32,
                                 eval_every=1, params_of=lambda t: t.model)
    tpop.run_population_loop(
        learner, seeds, ts, mk_args(checkpoint_every_iters=10),
        train_many=lambda t: learner.train_iteration_many(t)[:1] + ({},),
        total_units=1, steps_per_unit=32, eval_every=1, params_of=lambda t: t.model)
    out = capsys.readouterr().out
    assert "--checkpoint-every-iters" in out  # listed as ignored
    assert "not supported and are skipped" in out
    assert Path(tmp_path / "pop" / "policy_best" / "policy.json").exists()

    # through the CLI: a flag left at its parser default is not listed
    run_ppo.main(["--population", "2", "--env", "usv-simple", "--num-envs", "2", "--n-steps", "4",
                  "--batch-size", "8", "--total-steps", "8", "--eval-every-iters", "0",
                  "--video-every-iters", "3", "--select-evals", "1", "--eval-steps", "2",
                  "--eval-envs", "2", "--logdir", str(tmp_path / "cli"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "explicitly requested --video-every-iters will be ignored" in out
    assert "--checkpoint-every-iters" not in out and "--watch-every-iters" not in out

"""One optimizer step of a replayed PPO update against the JAX package's, on
the CPU.

``usv_tpu_torch/tools/replay_ppo_update.py`` replays a seed study's run to
the update after which its collect reward fell, traces that update step by
step and saves some steps' whole input (parameters, Adam's moments and
count, learning rate, fused minibatch). Here each saved step is repeated:

* by the port on the CPU, whose KL, clip fraction, gradient norm and loss
  must equal the trace's (1e-5 relative; the trace was taken on the CPU
  here, and on the card for a dump made there);
* by JAX's ``_loss``, ``jax.grad`` and ``tx.update`` from the same state:
  the KL within 1e-6, the clip fraction within two rows, the gradient norm
  and the loss within 1e-4 relative, and the parameters' change within 1e-4
  of its norm (the float32 drift of the forward carried through Adam).

The test replays a tiny run (4 envs, 16 steps, 2 fused minibatches an
epoch) and also holds the replayed collect rewards to the recorded run's to
the digit. On a dump made on the card,
``python tests/test_torch_ppo_replay.py <out>`` prints the same comparison
for every saved step as JSON.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TRAIN_ARGS = ["--num-envs", "4", "--n-steps", "16", "--batch-size", "8"]
ITERATION = 4  # the replay traces the updates of iterations 2 and 3


def nest(arrays):
    """'/'-joined paths -> nested dicts."""
    out = {}
    for path, value in arrays.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def load_step(path):
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    groups = {g: {k.split("/", 1)[1]: v for k, v in data.items() if k.startswith(g + "/")}
              for g in ("params", "exp_avg", "exp_avg_sq", "batch")}
    return dict(groups, opt_steps=int(data["opt_steps"]), adam_step=int(data["adam_step"]),
                lr=float(data["lr"]))


def port_step(env_id, config, step):
    """The port's stats and new parameters for ``step``, on the CPU."""
    from usv_tpu_torch import envs as tenvs
    from usv_tpu_torch.tools.replay_ppo_update import step_stats
    from usv_tpu_torch.train import ppo as tppo

    learner = tppo.PpoLearner(tenvs.make(env_id, device="cpu"), tppo.PpoConfig(**config))
    ts = learner.init(0)
    ts.model.load_state_dict({k: torch.from_numpy(v) for k, v in step["params"].items()}, strict=True)
    for name, p in ts.model.named_parameters():
        ts.opt.state[p] = dict(step=torch.tensor(float(step["adam_step"])),
                               exp_avg=torch.from_numpy(step["exp_avg"][name]).clone(),
                               exp_avg_sq=torch.from_numpy(step["exp_avg_sq"][name]).clone())
    ts.opt_steps = step["opt_steps"]
    assert learner.lr_at(ts.opt_steps) == pytest.approx(step["lr"], rel=1e-12)
    batch = {k: torch.from_numpy(v) for k, v in step["batch"].items()}
    stats = {k: float(v) for k, v in step_stats(learner, ts, batch).items()}
    learner._minibatch_step(ts, batch)
    return stats, {k: v.detach().clone() for k, v in ts.model.state_dict().items()}


def jax_step(env_id, config, step):
    """JAX's stats and new parameters for ``step`` (its ``minibatch`` body)."""
    import jax
    import jax.numpy as jnp
    import optax

    from usv_tpu import envs as jenvs
    from usv_tpu.train import ppo as jppo
    from usv_tpu_torch import convert

    learner = jppo.PpoLearner(jenvs.make(env_id), jppo.PpoConfig(**config))
    flax = convert.state_dict_to_flax({k: torch.from_numpy(v) for k, v in step["params"].items()})

    def tree(group):
        arrays = convert.state_dict_to_flax({k: torch.from_numpy(v) for k, v in step[group].items()})
        return jax.tree.map(jnp.asarray, nest(arrays))

    params = jax.tree.map(jnp.asarray, nest(flax))
    count = jnp.asarray(step["adam_step"], jnp.int32)

    def restore(state):
        if isinstance(state, optax.ScaleByAdamState):
            return state._replace(count=count, mu=tree("exp_avg"), nu=tree("exp_avg_sq"))
        if isinstance(state, optax.ScaleByScheduleState):
            return state._replace(count=jnp.asarray(step["opt_steps"], jnp.int32))
        if isinstance(state, tuple) and not hasattr(state, "_fields"):
            return tuple(restore(s) for s in state)
        return state

    opt_state = restore(learner.tx.init(params))
    batch = {k: jnp.asarray(v) for k, v in step["batch"].items()}
    cfg = learner.cfg
    logp, entropy, value = learner.model.log_prob(params, batch["obs"], batch["action"])
    log_ratio = logp - batch["logp"]
    ratio = jnp.exp(log_ratio)
    loss, grads = jax.value_and_grad(learner._loss)(params, batch, cfg.clip_range, cfg.ent_coef,
                                                     cfg.vf_coef)
    updates, _ = learner.tx.update(grads, opt_state, params)
    new = optax.apply_updates(params, updates)
    stats = dict(approx_kl=float(((ratio - 1) - log_ratio).mean()),
                 clip_fraction=float((jnp.abs(ratio - 1) > cfg.clip_range).mean()),
                 grad_norm=float(optax.global_norm(grads)), loss=float(loss),
                 value_loss=float(jnp.square(value - batch["ret"]).mean()),
                 entropy=float(entropy.mean()))
    from tests.test_torch_ppo import flatten

    return stats, convert.state_dict_from_flax(flatten(new))


def compare(out, index):
    """The trace's, the port's and JAX's view of saved step ``index``."""
    trace = json.loads((Path(out) / "trace.json").read_text())
    config = dict(trace["config"], pi_hidden=tuple(trace["config"]["pi_hidden"]),
                  vf_hidden=tuple(trace["config"]["vf_hidden"]))
    step = load_step(Path(out) / f"step{index}.npz")
    recorded = trace["iterations"][1]["steps"][index]
    port, port_params = port_step(trace["env"], config, step)
    jax_stats, jax_params = jax_step(trace["env"], config, step)
    before = {k: torch.from_numpy(v) for k, v in step["params"].items()}
    num = sum(float((port_params[k] - jax_params[k]).square().sum()) for k in before)
    den = sum(float((jax_params[k] - before[k]).square().sum()) for k in before)
    return dict(step=index, rows=int(step["batch"]["adv"].shape[0]), lr=step["lr"], recorded=recorded,
                port=port, jax=jax_stats, change_gap=(num / den) ** 0.5)


@pytest.fixture(scope="module")
def replayed(tmp_path_factory):
    from usv_tpu_torch.tools import replay_ppo_update, study_ppo_k4_seeds as study
    from usv_tpu_torch.train import run_ppo

    tmp = tmp_path_factory.mktemp("ppo_replay")
    flags = ["--total-steps", str(64 * (ITERATION + 2)), "--env", "usv-simple", "--eval-steps", "8",
             "--device", "cpu"] + [f"--train-arg={a}" for a in TRAIN_ARGS]
    args = study.build_parser().parse_args(flags)
    run_ppo.main(study.train_argv(args, 1, str(tmp / "record")))
    trace = replay_ppo_update.main(
        flags + ["--seed", "1", "--iteration", str(ITERATION), "--outdir", str(tmp / "replay"),
                 "--expect", str(tmp / "record" / "metrics.jsonl"), "--out", str(tmp / "out")])
    return trace, tmp / "out"


def test_the_replay_repeats_the_record_and_traces_every_step(replayed):
    trace, out = replayed
    assert trace["replay_equals_record"] is True
    assert [r["iteration"] for r in trace["iterations"]] == [2, 3, 4]
    for rec in trace["iterations"][:2]:
        # 10 epochs of 2 fused minibatches of 32 rows
        assert len(rec["steps"]) == 20
        assert rec["steps"][0]["approx_kl"] == pytest.approx(0.0, abs=1e-6)
    assert "steps" not in trace["iterations"][2]
    # the largest gradient norm's step, the first and the largest KL's, all under --dump-mb
    steps = trace["iterations"][1]["steps"]
    want = [int(np.argmax([s["grad_norm"] for s in steps])), 0,
            int(np.argmax([s["approx_kl"] for s in steps]))]
    assert trace["saved_steps"] == list(dict.fromkeys(want))
    assert all((out / f"step{i}.npz").exists() for i in trace["saved_steps"])


@pytest.mark.parametrize("which", ["first", "largest KL"])
def test_a_saved_step_matches_the_trace_and_jax(replayed, which):
    pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")
    trace, out = replayed
    steps = trace["iterations"][1]["steps"]
    index = 0 if which == "first" else int(np.argmax([s["approx_kl"] for s in steps]))
    assert index in trace["saved_steps"]
    got = compare(out, index)
    assert got["rows"] == 32
    for k, v in got["recorded"].items():
        if k != "lr":
            assert got["port"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    port, jax_stats = got["port"], got["jax"]
    assert port["approx_kl"] == pytest.approx(jax_stats["approx_kl"], abs=1e-6)
    assert abs(port["clip_fraction"] - jax_stats["clip_fraction"]) <= 2 / got["rows"]
    for k in ("grad_norm", "loss", "value_loss", "entropy"):
        assert port[k] == pytest.approx(jax_stats[k], rel=1e-4), k
    assert got["change_gap"] <= 1e-4


if __name__ == "__main__":
    # python tests/test_torch_ppo_replay.py <replay out dir>: every saved step
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    where = Path(sys.argv[1])
    saved = json.loads((where / "trace.json").read_text())["saved_steps"]
    print(json.dumps([compare(where, i) for i in saved], indent=1))

"""Standalone policy bundles: a trained actor saved for deployment — port of
``usv_tpu/train/policy.py``.

A bundle is a directory with a small JSON of architecture metadata
(``policy.json``, the JAX package's keys) and the actor's parameters
(``params.pt``: ``torch.save`` of the module's ``state_dict``, loaded with
``weights_only=True``). :func:`load_policy` rebuilds a pure ``obs -> action``
function with no learner, env or replay machinery attached, for an
on-vehicle control loop or a batch inference server. It also accepts the
``policy_np.npz`` that either package's :func:`export_numpy_policy` writes, so
a policy trained with the JAX package is served here.

:func:`export_policy` writes a learner's deterministic policy as a bundle;
:func:`replay_recorded_eval` reruns the in-run eval that a ``policy_best``
bundle records.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from usv_tpu_torch.convert import state_dict_from_flax, state_dict_to_flax
from usv_tpu_torch.envs.registry import resolve_device
from usv_tpu_torch.models.mlp import PpoActorCritic, SquashedGaussianActor

PARAMS_FILE = "params.pt"
NUMPY_FILE = "policy_np.npz"


def build_module(meta: dict) -> torch.nn.Module:
    """The network a bundle's metadata describes, freshly initialized, in
    float32 (the JAX package's ``Policy`` serves in float32 whatever
    ``compute_dtype`` the run trained under)."""
    if meta["kind"] == "sac":
        return SquashedGaussianActor(
            obs_dim=meta["obs_dim"],
            action_dim=meta["action_dim"],
            hidden=tuple(meta["hidden"]),
            log_std_init=meta["log_std_init"],
            action_low=tuple(meta["action_low"]),
            action_high=tuple(meta["action_high"]),
            use_sde=meta["use_sde"],
        )
    if meta["kind"] == "ppo":
        return PpoActorCritic(
            obs_dim=meta["obs_dim"],
            action_dim=meta["action_dim"],
            pi_hidden=tuple(meta["pi_hidden"]),
            vf_hidden=tuple(meta["vf_hidden"]),
            log_std_init=meta["log_std_init"],
            use_sde=meta["use_sde"],
        )
    raise ValueError(f"unsupported policy kind {meta['kind']!r}")


def module_meta(module, frame_stack: int, action_low=None, action_high=None,
                compute_dtype: str = "float32") -> dict:
    """The ``policy.json`` metadata of an actor module, with the JAX
    package's keys. A PPO module does not hold the action bounds: pass the
    env config's."""
    if isinstance(module, SquashedGaussianActor):
        return dict(
            kind="sac",
            obs_dim=module.obs_dim,
            action_dim=module.action_dim,
            hidden=list(module.hidden),
            log_std_init=module.log_std_init,
            action_low=module.action_low.tolist() if action_low is None else list(action_low),
            action_high=module.action_high.tolist() if action_high is None else list(action_high),
            use_sde=module.use_sde,
            frame_stack=frame_stack,
            compute_dtype=compute_dtype,
        )
    if isinstance(module, PpoActorCritic):
        if action_low is None or action_high is None:
            raise ValueError("a PPO bundle needs the env's action_low and action_high")
        return dict(
            kind="ppo",
            obs_dim=module.obs_dim,
            action_dim=module.action_dim,
            pi_hidden=list(module.pi_hidden),
            vf_hidden=list(module.vf_hidden),
            log_std_init=module.log_std_init,
            action_low=[float(v) for v in action_low],
            action_high=[float(v) for v in action_high],
            use_sde=module.use_sde,
            frame_stack=frame_stack,
            compute_dtype=compute_dtype,
        )
    raise TypeError(f"unsupported module type {type(module)!r}")


def save_policy(meta: dict, module: torch.nn.Module, path, extra_meta=None) -> str:
    """Write the bundle ``path``: ``policy.json`` and ``params.pt``.

    ``extra_meta`` (a JSON-serializable dict) is merged into the metadata —
    the place for :func:`in_run_eval_meta`'s record of the eval that selected
    a ``policy_best`` export.
    """
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    meta = dict(meta)
    if extra_meta:
        meta.update(extra_meta)
    (path / "policy.json").write_text(json.dumps(meta, indent=1))
    state = {k: v.detach().to("cpu") for k, v in module.state_dict().items()}
    torch.save(state, path / PARAMS_FILE)
    return str(path)


def export_policy(learner, train_state, path, extra_meta=None) -> str:
    """Save the deterministic policy of a Sac/Ppo learner to ``path``: the
    bundle :func:`save_policy` writes, with the JAX package's ``policy.json``
    keys for kind ``"sac"`` and ``"ppo"``. ``extra_meta`` is merged into the
    metadata — the train CLIs record there the in-run eval that selected a
    ``policy_best`` export (:func:`in_run_eval_meta`)."""
    from usv_tpu_torch.train.ppo import PpoLearner
    from usv_tpu_torch.train.sac import SacLearner

    if isinstance(learner, SacLearner):
        module = train_state.actor
        low, high = learner.action_low, learner.action_high
    elif isinstance(learner, PpoLearner):
        module = train_state.model
        low, high = learner.handle.cfg.action_low, learner.handle.cfg.action_high
    else:
        raise TypeError(f"unsupported learner type {type(learner)!r}")
    meta = module_meta(module, learner.cfg.frame_stack, [float(v) for v in low],
                       [float(v) for v in high], compute_dtype=learner.cfg.compute_dtype)
    return save_policy(meta, module, path, extra_meta=extra_meta)


def in_run_eval_meta(env_id, best_metric, score, stats, eval_seed,
                     n_steps, num_envs) -> dict:
    """Build the ``in_run_eval`` metadata block attached to a ``policy_best``
    export: the selection score, the full eval stats, the protocol shape,
    and the seed of the eval's generator (where the JAX package stores its
    key's raw data), so that the identical eval can be rerun."""
    return {"in_run_eval": dict(
        env=env_id,
        best_metric=best_metric,
        score=float(score),
        stats={k: float(v) for k, v in stats.items()},
        n_steps=int(n_steps),
        num_envs=int(num_envs),
        seed=int(eval_seed),
    )}


def replay_recorded_eval(handle, bundle_path) -> dict:
    """Re-run a bundle's recorded in-run eval (the learner's eval program,
    the bundle's parameters, the recorded protocol shape and seed) on
    ``handle``'s device and return ``{"recorded": ..., "replayed": ...,
    "stats": ...}``.

    Agreement bit for bit attributes any in-run-vs-re-eval score gap to eval
    seed variance; disagreement would indicate export infidelity. A bundle
    written by the JAX package records a JAX key, not a seed: its eval ran on
    JAX's key chain, which torch's generators cannot reproduce, so it is
    refused."""
    from usv_tpu_torch.train.metrics import score_eval_stats
    from usv_tpu_torch.train.ppo import PpoConfig, PpoLearner
    from usv_tpu_torch.train.sac import SacConfig, SacLearner

    policy = load_policy(bundle_path, device=handle.device)
    meta = policy.meta
    rec = meta.get("in_run_eval")
    if rec is None:
        raise ValueError(
            f"{bundle_path} has no recorded in-run eval (exported as a final "
            "'policy' rather than 'policy_best', or by an older CLI)"
        )
    if "seed" not in rec:
        raise ValueError(
            f"{bundle_path} records its in-run eval by a JAX key (key_data), not a seed: "
            "a JAX key cannot be replayed by torch's generators; replay it with the JAX "
            "package's run_eval --replay-recorded-eval"
        )
    if rec.get("env") and rec["env"] != handle.env_id:
        raise ValueError(
            f"bundle's recorded eval ran on {rec['env']!r} but the given "
            f"env handle is {handle.env_id!r} — replay with the recorded "
            "env (run_eval --env) or the comparison is meaningless"
        )
    # compute_dtype is restored too: a --bf16 run's in-run eval scored the
    # model with bfloat16 trunks (old bundles lack the field -> float32)
    compute_dtype = meta.get("compute_dtype", "float32")
    if meta["kind"] == "sac":
        learner = SacLearner(handle, SacConfig(
            hidden=tuple(meta["hidden"]), log_std_init=meta["log_std_init"],
            use_sde=meta["use_sde"], frame_stack=meta["frame_stack"], num_envs=rec["num_envs"],
            compute_dtype=compute_dtype, action_low=tuple(meta["action_low"]),
            action_high=tuple(meta["action_high"]),
            # one write block: the learner's replay buffer is never used here
            buffer_size=rec["num_envs"] * SacConfig.train_freq))
        net = learner.build_actor()
    else:
        learner = PpoLearner(handle, PpoConfig(
            pi_hidden=tuple(meta["pi_hidden"]), vf_hidden=tuple(meta["vf_hidden"]),
            log_std_init=meta["log_std_init"], use_sde=meta["use_sde"],
            frame_stack=meta["frame_stack"], num_envs=rec["num_envs"],
            compute_dtype=compute_dtype))
        net = learner.build_model()
    net.load_state_dict(policy.module.state_dict(), strict=True)
    stats = learner.eval_policy_stats_at(net.to(handle.device), rec["seed"],
                                         n_steps=rec["n_steps"], num_envs=rec["num_envs"])
    _, replayed = score_eval_stats(stats, rec.get("best_metric", "reward"))
    return dict(recorded=rec["score"], replayed=float(replayed), stats=stats)


class Policy:
    """A reloaded deterministic policy: ``policy(obs) -> action``.

    ``obs`` is the (frame-stacked) observation vector ``(obs_dim,)`` or a
    batch ``(B, obs_dim)``, a tensor or anything ``torch.as_tensor`` takes;
    actions come back as a tensor on the policy's device, in env units
    (already scaled to the exported action bounds). PPO bundles clip the
    Gaussian mean to the action bounds, matching how collection clips before
    stepping. No gradient is recorded.
    """

    def __init__(self, meta: dict, module: torch.nn.Module, device=None):
        self.meta = meta
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.obs_dim = meta["obs_dim"]
        self.action_dim = meta["action_dim"]
        self.frame_stack = meta["frame_stack"]
        self._low = torch.tensor(meta["action_low"], dtype=torch.float32, device=self.device)
        self._high = torch.tensor(meta["action_high"], dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def __call__(self, obs):
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        squeeze = obs.dim() == 1
        x = obs[None] if squeeze else obs
        if self.meta["kind"] == "sac":
            out = self.module.deterministic(x)
        else:
            out = torch.clamp(self.module.pi_mean(self.module.pi_trunk(x)), self._low, self._high)
        return out[0] if squeeze else out


def _load_numpy_arrays(npz_path):
    with np.load(npz_path) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return meta, arrays


def load_policy(path, device=None) -> Policy:
    """Load a bundle onto ``device`` (the CUDA device unless the caller names
    another): a directory written by :func:`save_policy`, or a
    ``policy_np.npz`` (the file itself, or a directory that holds one and no
    ``params.pt``) in the layout of :func:`export_numpy_policy`."""
    path = Path(path).absolute()
    if path.is_dir() and (path / PARAMS_FILE).exists():
        meta = json.loads((path / "policy.json").read_text())
        state = torch.load(path / PARAMS_FILE, map_location="cpu", weights_only=True)
    else:
        npz = path / NUMPY_FILE if path.is_dir() else path
        if not npz.exists():
            raise FileNotFoundError(f"{path}: neither a bundle with {PARAMS_FILE} nor a {NUMPY_FILE}")
        meta, arrays = _load_numpy_arrays(npz)
        state = state_dict_from_flax(arrays)
    module = build_module(meta)
    module.load_state_dict(state, strict=True)
    return Policy(meta, module, device)


def export_numpy_policy(bundle_path, out_path=None) -> str:
    """Convert a bundle into one ``.npz`` servable with NumPy alone.

    Flattens the actor's parameters to '/'-joined flax paths (kernels as
    ``(in, out)``) and embeds the bundle metadata, so
    ``usv_tpu_torch.utils.numpy_policy.load_numpy_policy`` — and the JAX
    package's loader, the layout being its own — rebuilds the deterministic
    policy with NumPy alone.
    """
    bundle_path = Path(bundle_path).absolute()
    policy = load_policy(bundle_path, device="cpu")
    arrays = state_dict_to_flax(policy.module.state_dict())
    out_path = Path(out_path) if out_path else bundle_path / NUMPY_FILE
    np.savez(out_path, __meta__=np.asarray(json.dumps(policy.meta)), **arrays)
    return str(out_path)

"""Training and serving: the replay buffer, the SAC and PPO learners, seed
populations, checkpoints, the train CLIs (``run_sac``, ``run_ppo``), policy
bundles, the batched evaluation and its CLI (``run_eval``).

The package exports the JAX package's names (``ReplayBuffer``,
``buffer_add_batch``, ``buffer_init``, ``buffer_sample``, ``SacConfig``,
``SacLearner``, ``PpoConfig``, ``PpoLearner``, ``Policy``, ``export_policy``,
``load_policy``) and ``save_policy``. The buffer's and the learners' are
imported on first access, so that serving a bundle (``run_eval``) loads no
learner.
"""

from usv_tpu_torch.train.policy import Policy, export_policy, load_policy, save_policy

_LAZY = {
    "ReplayBuffer": "buffer",
    "buffer_add_batch": "buffer",
    "buffer_init": "buffer",
    "buffer_sample": "buffer",
    "SacConfig": "sac",
    "SacLearner": "sac",
    "PpoConfig": "ppo",
    "PpoLearner": "ppo",
}

__all__ = ["Policy", "export_policy", "load_policy", "save_policy", *_LAZY]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(f"{__name__}.{_LAZY[name]}"), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))

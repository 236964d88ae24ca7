"""Training and serving: the replay buffer, the SAC and PPO learners,
checkpoints, the train CLIs (``run_sac``, ``run_ppo``), policy bundles, the
batched evaluation and its CLI (``run_eval``). Seed populations wait for
``train/population.py``."""

from usv_tpu_torch.train.policy import Policy, load_policy, save_policy

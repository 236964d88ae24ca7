"""Serving a trained policy: bundles, the batched evaluation and its CLI.
The learners are not ported yet."""

from usv_tpu_torch.train.policy import Policy, load_policy, save_policy

"""Utilities around the envs: the numerical guards."""

from usv_tpu_torch.utils.guards import (
    checked_step,
    is_state_finite,
    is_state_sane,
    make_sanitized_step,
)

"""Utilities around the envs: the numerical guards, the curved-path
generator and the numpy-only policy."""

from usv_tpu_torch.utils.guards import (
    checked_step,
    is_state_finite,
    is_state_sane,
    make_sanitized_step,
)
from usv_tpu_torch.utils.path_gen import (
    generate_path,
    place_obstacles,
    plot_path,
    simplified_lookahead,
)

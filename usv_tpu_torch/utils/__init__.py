"""Utilities around the envs: the numerical guards, the curved-path
generator, the numpy-only policy, the streaming IIR filter, and (imported
from their modules: they need pygame, cv2 or imageio) the renderers in
``viz`` and the videos in ``video``."""

from usv_tpu_torch.utils.guards import (
    checked_step,
    is_state_finite,
    is_state_sane,
    make_sanitized_step,
)
from usv_tpu_torch.utils.live_filter import LiveLFilter, iir_filter_scan
from usv_tpu_torch.utils.path_gen import (
    generate_path,
    place_obstacles,
    plot_path,
    simplified_lookahead,
)

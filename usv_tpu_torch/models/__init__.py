"""The policy and value networks and the gSDE exploration state."""

from usv_tpu_torch.models.mlp import (
    MLP,
    DoubleCritic,
    PpoActorCritic,
    SquashedGaussianActor,
)
from usv_tpu_torch.models.sde import SdeState, init_sde, maybe_resample

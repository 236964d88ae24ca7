"""Seeds derived without drawing, and seeded generators: shared by the
vector layer (the rollout's policy generator) and the learners."""

from __future__ import annotations

import numpy as np
import torch


def derived_seed(*words: int) -> int:
    """A 32-bit seed mixed from ``words`` (the run's seed, its counters and a
    purpose tag) — the port's ``jax.random.fold_in``: it draws nothing from
    any generator, so deriving it leaves the training stream untouched."""
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(1)[0])


def new_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g

"""The port's core math (``usv_tpu_torch.core``) against ``usv_tpu.core``.

Inputs come from a seeded numpy generator and go to both; outputs must agree
to atol=1e-6 (float32; coordinates lie in [-1.5, 1.5], so the outputs stay
within a few units, where 1e-6 is a few ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the JAX reference's envs need flax; a card-only machine may lack it, and
# then this file (CPU parity only) skips as a whole
pytest.importorskip("flax", reason="the JAX reference (usv_tpu.envs) needs flax")

import usv_tpu.core as jcore
import usv_tpu_torch.core as tcore
from usv_tpu.envs.types import TimeStep as JTimeStep
from usv_tpu_torch.envs.types import TimeStep

ATOL = 1e-6
N = 257


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, lo=-1.5, hi=1.5: rng.uniform(lo, hi, shape).astype(np.float32)  # noqa: E731
    return {
        "angle": f(N, lo=-10.0, hi=10.0),
        "xy": f(N, 2),
        "start": f(N, 2),
        "end": f(N, 2),
        "progress": f(N, lo=0.0, hi=1.0),
        "x": f(N, lo=-3.0, hi=3.0),
    }


CASES = {
    "wrap_angle": lambda m, a: m.wrap_angle(a["angle"]),
    "wrap_angle_once": lambda m, a: m.wrap_angle_once(a["angle"]),
    "rot2": lambda m, a: m.rot2(a["angle"]),
    "body_to_world": lambda m, a: m.body_to_world(a["xy"], a["angle"]),
    "world_to_body": lambda m, a: m.world_to_body(a["xy"], a["angle"]),
    "cross_track_error": lambda m, a: m.cross_track_error(a["xy"], a["start"], a["end"]),
    "closest_point_on_segment": lambda m, a: m.closest_point_on_segment(
        a["xy"], a["start"], a["end"], a["progress"], 0.01
    ),
    "angle_to_point": lambda m, a: m.angle_to_point(a["xy"], a["angle"], a["end"]),
    "map_range": lambda m, a: m.map_range(a["x"], -3.0, 3.0, 0.5, 2.0),
    "normalize_val": lambda m, a: m.normalize_val(a["x"], -3.0, 3.0),
    "denormalize_val": lambda m, a: m.denormalize_val(a["x"], 0.5, 2.0),
}


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_core_matches_jax(name, seed):
    a = _inputs(seed)
    want = _flat(CASES[name](jcore, {k: jnp.asarray(v) for k, v in a.items()}))
    got = _flat(CASES[name](tcore, {k: torch.from_numpy(v) for k, v in a.items()}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_wrap_angle_edges_match_jax():
    a = np.array([np.pi, -np.pi, 3 * np.pi, -3.5 * np.pi, 0.0, 1e-7], np.float32)
    for fn in ("wrap_angle", "wrap_angle_once"):
        want = np.asarray(getattr(jcore, fn)(jnp.asarray(a)))
        got = getattr(tcore, fn)(torch.from_numpy(a)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_timestep_done_matches_jax():
    rng = np.random.default_rng(0)
    term, trunc = rng.uniform(size=(2, 64)) > 0.5
    want = JTimeStep(obs=None, reward=None, terminated=jnp.asarray(term),
                     truncated=jnp.asarray(trunc), info={}).done
    got = TimeStep(obs=None, reward=None, terminated=torch.from_numpy(term),
                   truncated=torch.from_numpy(trunc), info={}).done
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

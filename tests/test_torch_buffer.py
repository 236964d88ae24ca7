"""The port's replay buffer (``train/buffer.py``) against ``usv_tpu``'s, on
the CPU: the same insert sequences give the same arrays, ``ptr`` and
``size`` bit for bit (wrap-around scatter and aligned slice path), sampling
by JAX's ``randint`` indices gives JAX's batch bit for bit, and both
``ValueError``s fire where JAX's do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu) needs flax")

from usv_tpu.train import buffer as jbuffer
from usv_tpu_torch.train import buffer as tbuffer

OBS, ACT = 5, 2


def _rows(rng, b):
    return dict(obs=rng.standard_normal((b, OBS)).astype(np.float32),
                action=rng.standard_normal((b, ACT)).astype(np.float32),
                reward=rng.standard_normal(b).astype(np.float32),
                next_obs=rng.standard_normal((b, OBS)).astype(np.float32),
                done=(rng.random(b) < 0.3).astype(np.float32))


def _same(tbuf, jbuf):
    for name in tbuffer.ReplayBuffer.FIELDS:
        np.testing.assert_array_equal(getattr(tbuf, name).numpy(), np.asarray(getattr(jbuf, name)),
                                      err_msg=name)
    assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))


@pytest.mark.parametrize("aligned,sizes", [(False, [6, 3, 7, 10, 1]), (True, [4] * 7)],
                         ids=["wrap_scatter", "aligned_slice"])
def test_inserts_match_jax(aligned, sizes):
    cap = 12 if aligned else 10
    tbuf = tbuffer.buffer_init(cap, OBS, ACT)
    jbuf = jbuffer.buffer_init(cap, OBS, ACT)
    rng = np.random.default_rng(0)
    wrapped = False
    for b in sizes:
        rows = _rows(rng, b)
        wrapped |= tbuf.ptr + b > cap
        out = tbuffer.buffer_add_batch(tbuf, *(torch.from_numpy(rows[k]) for k in tbuffer.ReplayBuffer.FIELDS),
                                       aligned=aligned)
        assert out is tbuf  # written in place
        jbuf = jbuffer.buffer_add_batch(jbuf, *(jnp.asarray(rows[k]) for k in tbuffer.ReplayBuffer.FIELDS),
                                        aligned=aligned)
        _same(tbuf, jbuf)
    assert tbuf.size == cap and (wrapped or aligned)
    assert tbuf.capacity == cap and tbuf.nbytes() == 4 * cap * (2 * OBS + ACT + 2)


def test_sampling_by_jax_indices_and_by_generator():
    tbuf = tbuffer.buffer_init(16, OBS, ACT)
    jbuf = jbuffer.buffer_init(16, OBS, ACT)
    rows = _rows(np.random.default_rng(1), 11)
    tbuffer.buffer_add_batch(tbuf, *(torch.from_numpy(rows[k]) for k in tbuffer.ReplayBuffer.FIELDS))
    jbuf = jbuffer.buffer_add_batch(jbuf, *(jnp.asarray(rows[k]) for k in tbuffer.ReplayBuffer.FIELDS))
    key = jax.random.key(3)
    want = jbuffer.buffer_sample(jbuf, key, 32)
    # the draw inside buffer_sample, fed to the port
    idx = np.array(jax.random.randint(key, (32,), 0, jnp.maximum(jbuf.size, 1)))
    got = tbuffer.buffer_sample(tbuf, 32, idx=torch.from_numpy(idx).long())
    for name in tbuffer.ReplayBuffer.FIELDS:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    # from a generator: rows of the filled part only, reproducible by seed
    a = tbuffer.buffer_sample(tbuf, 64, generator=torch.Generator().manual_seed(0))
    b = tbuffer.buffer_sample(tbuf, 64, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a[k], b[k]) for k in a)
    filled = {tuple(r) for r in rows["obs"].tolist()}
    assert {tuple(r) for r in a["obs"].tolist()} <= filled
    # an empty buffer samples its zero row, as JAX's max(size, 1)
    empty = tbuffer.buffer_sample(tbuffer.buffer_init(4, OBS, ACT), 3)
    assert empty["obs"].shape == (3, OBS) and not empty["obs"].any()


def test_insert_errors_match_jax():
    tbuf = tbuffer.buffer_init(12, OBS, ACT)
    jbuf = jbuffer.buffer_init(12, OBS, ACT)
    for b, aligned, word in ((13, False, "exceeds"), (5, True, "aligned")):
        rows = _rows(np.random.default_rng(2), b)
        with pytest.raises(ValueError, match=word):
            tbuffer.buffer_add_batch(tbuf, *(torch.from_numpy(rows[k]) for k in tbuffer.ReplayBuffer.FIELDS),
                                     aligned=aligned)
        with pytest.raises(ValueError, match=word):
            jbuffer.buffer_add_batch(jbuf, *(jnp.asarray(rows[k]) for k in tbuffer.ReplayBuffer.FIELDS),
                                     aligned=aligned)
    assert (tbuf.ptr, tbuf.size) == (0, 0)  # nothing was written

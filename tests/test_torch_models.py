"""The port's ``models`` against ``usv_tpu.models`` (flax), on the CPU, with
the weights carried across by ``convert.state_dict_from_flax``.

Small widths (hidden 32x24, batch 16) beside one forward at the full width
(715-400-300). Inputs and weights come from numpy and JAX seeds; where a flax
method draws from a key, the port is handed the same normals. Tolerances:
float32 outputs at atol=1e-5 with rtol=1e-5 (sums of up to 715 products in
two summation orders); log-probs, sums over the action dimension of terms of
a few units, at atol=2e-5 (PPO's log-prob of a given action reaches ~120, one
float32 ulp 7.6e-6: atol=5e-5); the bfloat16 trunk at atol=3e-2 with rtol=2e-2 (a
bfloat16 ulp is 0.4% of the value, the two sides round the bias add
differently, and two layers compound it).
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax", reason="the JAX reference (usv_tpu.models) needs flax")

from usv_tpu.models import mlp as jmlp
from usv_tpu.models import sde as jsde
from usv_tpu_torch import convert
from usv_tpu_torch.models import mlp as tmlp
from usv_tpu_torch.models import sde as tsde

TOL = dict(atol=1e-5, rtol=1e-5)
LOGP_TOL = dict(atol=2e-5, rtol=1e-5)
B, OBS, ACT, HIDDEN = 16, 20, 2, (32, 24)


def flatten(tree, prefix=""):
    """A flax params tree as '/'-joined paths -> numpy arrays: the layout the
    JAX package's ``export_numpy_policy`` writes."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.array(v)
    return out


def randomized(params, seed, scale=0.1):
    """Flax initial params with every leaf perturbed, so that no bias is zero
    and no log-std constant: a head that is dropped or swapped shows. The
    perturbation is small enough that the pre-tanh means stay of order 1,
    off the saturated tail where ``log(1 - tanh^2)`` magnifies the last bit."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [
        leaf + scale * jnp.asarray(rng.standard_normal(leaf.shape), jnp.float32)
        for leaf in leaves])


def obs_batch(seed, dim=OBS, batch=B):
    return np.random.default_rng(seed).standard_normal((batch, dim)).astype(np.float32)


def load(module, params):
    module.load_state_dict(convert.state_dict_from_flax(flatten(params)), strict=True)
    return module.eval()


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("activate_final", [False, True])
def test_mlp_matches_flax(activate_final):
    x = obs_batch(0)
    jnet = jmlp.MLP((32, 24, 5), activate_final=activate_final)
    params = randomized(jnet.init(jax.random.key(0), x), 1)
    tnet = load(tmlp.MLP(OBS, (32, 24, 5), activate_final=activate_final), params)
    out = tnet(torch.from_numpy(x))
    close(out, jnet.apply(params, x))
    assert bool((out >= 0).all()) == activate_final


def _actors(use_sde, dtype="float32", hidden=HIDDEN, obs_dim=OBS, low=(0.2, -1.0), high=(1.0, 1.0),
            scale=0.1):
    jnet = jmlp.SquashedGaussianActor(
        action_dim=ACT, hidden=hidden, action_low=low, action_high=high, use_sde=use_sde,
        compute_dtype=getattr(jnp, dtype))
    params = randomized(jnet.init(jax.random.key(2), jnp.zeros((1, obs_dim))), 3, scale)
    tnet = load(tmlp.SquashedGaussianActor(
        obs_dim, ACT, hidden=hidden, action_low=low, action_high=high, use_sde=use_sde,
        compute_dtype=getattr(torch, dtype)), params)
    return jnet, params, tnet


@pytest.mark.parametrize("use_sde", [False, True], ids=["plain", "gsde"])
def test_squashed_gaussian_actor_matches_flax(use_sde):
    jnet, params, tnet = _actors(use_sde)
    x = obs_batch(4)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        mean, log_std = tnet(tx)
        jmean, jlog_std = jnet.apply(params, x)
        close(mean, jmean)
        close(log_std, jlog_std)
        assert log_std.min() >= -20.0 and log_std.max() <= 2.0
        close(tnet.deterministic(tx), jnet.deterministic(params, x))

        key = jax.random.key(5)
        noise = np.array(jax.random.normal(key, (B, ACT)))
        action, logp, mean_action = tnet.sample(tx, noise=torch.from_numpy(noise))
        jaction, jlogp, jmean_action = jnet.sample(params, x, key)
        close(action, jaction)
        close(logp, jlogp, **LOGP_TOL)
        close(mean_action, jmean_action)
        low, high = torch.tensor([0.2, -1.0]), torch.tensor([1.0, 1.0])
        assert ((action >= low) & (action <= high)).all()
        # a generator draws noise of the same shape
        drawn = tnet.sample(tx, generator=torch.Generator().manual_seed(0))[0]
        assert drawn.shape == (B, ACT) and not torch.equal(drawn, action)

        if use_sde:
            trunk, lmean, mat = tnet.latent(tx)
            jtrunk, jlmean, jmat = jnet.apply(params, x, method=jnet.latent)
            close(trunk, jtrunk)
            close(lmean, jlmean)
            close(mat, jmat)
            jstate = jsde.init_sde(jax.random.key(6), HIDDEN[-1], ACT, (B,))
            tstate = tsde.SdeState(torch.from_numpy(np.array(jstate.exploration_mat)),
                                   torch.from_numpy(np.array(jstate.step)))
            close(tnet.sample_sde(tx, tstate), jnet.sample_sde(params, x, jstate))
        else:
            with pytest.raises(ValueError, match="use_sde"):
                tnet.latent(tx)


def test_log_std_is_clipped_after_the_gsde_log():
    """A huge log-std matrix: sde_std clips it to 2 first, then log of the
    marginal (over 24 features) exceeds 2 and is clipped again."""
    jnet, params, tnet = _actors(True)
    with torch.no_grad():
        tnet.log_std_sde.fill_(9.0)
        params = jax.tree.map(lambda x: x, params)
        params["params"]["log_std_sde"] = jnp.full((HIDDEN[-1], ACT), 9.0)
        x = np.abs(obs_batch(7)) * 3
        log_std = tnet(torch.from_numpy(x))[1]
        close(log_std, jnet.apply(params, x)[1])
        assert (log_std == 2.0).any()


def test_actor_full_width_forward_matches_flax():
    jnet, params, tnet = _actors(True, hidden=(400, 300), obs_dim=715, scale=0.02)
    x = obs_batch(8, dim=715, batch=8)
    with torch.no_grad():
        close(tnet.deterministic(torch.from_numpy(x)), jnet.deterministic(params, x))
        mean, log_std = tnet(torch.from_numpy(x))
        jmean, jlog_std = jnet.apply(params, x)
        close(mean, jmean, atol=2e-5, rtol=1e-5)  # 715- and 400-term sums of O(1) products
        close(log_std, jlog_std, atol=2e-5, rtol=1e-5)
    assert sum(p.numel() for p in tnet.parameters()) == 715 * 400 + 400 + 400 * 300 + 300 \
        + 300 * 2 + 2 + 300 * 2


@pytest.mark.parametrize("use_sde", [False, True], ids=["plain", "gsde"])
def test_bfloat16_trunk_stays_near_flax(use_sde):
    jnet, params, tnet = _actors(use_sde, dtype="bfloat16")
    _, _, tnet32 = _actors(use_sde)
    x = obs_batch(9)
    with torch.no_grad():
        mean, log_std = tnet(torch.from_numpy(x))
        jmean, jlog_std = jnet.apply(params, x)
        assert mean.dtype == torch.float32 and log_std.dtype == torch.float32
        close(mean, jmean, atol=3e-2, rtol=2e-2)
        close(log_std, jlog_std, atol=3e-2, rtol=2e-2)
        # it is a bfloat16 trunk: it differs from the float32 one, and the
        # master weights stay float32
        assert (mean - tnet32(torch.from_numpy(x))[0]).abs().max() > 1e-4
        assert all(p.dtype == torch.float32 for p in tnet.parameters())


def test_double_critic_matches_flax():
    x, a = obs_batch(10), obs_batch(11, dim=ACT)
    jnet = jmlp.DoubleCritic(hidden=HIDDEN)
    params = randomized(jnet.init(jax.random.key(12), x, a), 13)
    tnet = load(tmlp.DoubleCritic(OBS, ACT, hidden=HIDDEN), params)
    with torch.no_grad():
        q1, q2 = tnet(torch.from_numpy(x), torch.from_numpy(a))
    jq1, jq2 = jnet.apply(params, x, a)
    close(q1, jq1)
    close(q2, jq2)
    assert q1.shape == (B,) and not torch.allclose(q1, q2)


def _ppo(use_sde, dtype="float32"):
    jnet = jmlp.PpoActorCritic(action_dim=ACT, pi_hidden=HIDDEN, vf_hidden=(24, 16),
                               use_sde=use_sde, compute_dtype=getattr(jnp, dtype))
    params = randomized(jnet.init(jax.random.key(14), jnp.zeros((1, OBS))), 15)
    tnet = load(tmlp.PpoActorCritic(OBS, ACT, pi_hidden=HIDDEN, vf_hidden=(24, 16),
                                    use_sde=use_sde, compute_dtype=getattr(torch, dtype)), params)
    return jnet, params, tnet


@pytest.mark.parametrize("use_sde", [False, True], ids=["plain", "gsde"])
def test_ppo_actor_critic_matches_flax(use_sde):
    jnet, params, tnet = _ppo(use_sde)
    assert tnet.log_std.shape == ((HIDDEN[-1], ACT) if use_sde else (ACT,))
    x = obs_batch(16)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        for got, want in zip(tnet(tx), jnet.apply(params, x)):
            close(got, want)
        close(tnet.value_only(tx), jnet.apply(params, x, method=jnet.value_only))

        key = jax.random.key(17)
        noise = np.array(jax.random.normal(key, (B, ACT)))
        for got, want in zip(tnet.sample(tx, noise=torch.from_numpy(noise)),
                             jnet.sample(params, x, key)):
            close(got, want, **LOGP_TOL)

        action = obs_batch(18, dim=ACT) * 0.3
        logp, entropy, value = tnet.log_prob(tx, torch.from_numpy(action))
        jlogp, jentropy, jvalue = jnet.log_prob(params, x, action)
        # logp holds z^2 / 2 with z = (action - mean) / std up to ~15: values
        # of up to ~120, whose float32 ulp is 7.6e-6
        close(logp, jlogp, atol=5e-5, rtol=1e-6)
        close(entropy, jentropy, **LOGP_TOL)
        close(value, jvalue)
        assert entropy.shape == (B,)

        if use_sde:
            jstate = jsde.init_sde(jax.random.key(19), HIDDEN[-1], ACT, (B,))
            tstate = tsde.SdeState(torch.from_numpy(np.array(jstate.exploration_mat)),
                                   torch.from_numpy(np.array(jstate.step)))
            for got, want in zip(tnet.sample_sde(tx, tstate), jnet.sample_sde(params, x, jstate)):
                close(got, want, **LOGP_TOL)


def test_sde_functions_match_jax():
    rng = np.random.default_rng(20)
    L = 24
    latent = np.abs(rng.standard_normal((B, L))).astype(np.float32)
    log_std = (rng.standard_normal((L, ACT)) - 2.0).astype(np.float32)
    log_std[0, 0], log_std[1, 1] = 5.0, -30.0  # both clips live
    action, mean = obs_batch(21, dim=ACT), obs_batch(22, dim=ACT)
    tl, tls = torch.from_numpy(latent), torch.from_numpy(log_std)
    close(tsde.sde_std(tl, tls), jsde.sde_std(latent, log_std))
    close(tsde.sde_log_prob(torch.from_numpy(action), torch.from_numpy(mean), tl, tls),
          jsde.sde_log_prob(action, mean, latent, log_std), **LOGP_TOL)
    close(tsde.sde_entropy(tl, tls), jsde.sde_entropy(latent, log_std))

    # the schedule: resample where step % freq == 0, always count on
    jstate = jsde.init_sde(jax.random.key(23), L, ACT, (B,))
    jstate = jstate.replace(step=jnp.arange(B, dtype=jnp.int32))
    tstate = tsde.SdeState(torch.from_numpy(np.array(jstate.exploration_mat)),
                           torch.from_numpy(np.array(jstate.step)))
    key = jax.random.key(24)
    fresh = np.array(jax.random.normal(key, (B, L, ACT)))
    jnew = jsde.maybe_resample(jstate, key, 4)
    tnew = tsde.maybe_resample(tstate, None, 4, normals=torch.from_numpy(fresh))
    np.testing.assert_array_equal(tnew.exploration_mat.numpy(), np.asarray(jnew.exploration_mat))
    np.testing.assert_array_equal(tnew.step.numpy(), np.asarray(jnew.step))
    due = torch.arange(B) % 4 == 0
    assert torch.equal(tnew.exploration_mat[~due], tstate.exploration_mat[~due])
    assert torch.equal(tnew.exploration_mat[due], torch.from_numpy(fresh)[due])
    close(tsde.sde_noise(tl, tls, tnew), jsde.sde_noise(latent, log_std, jnew))

    # one matrix for the whole batch, and the generator forms
    one = tsde.init_sde(torch.Generator().manual_seed(0), L, ACT)
    assert one.exploration_mat.shape == (L, ACT) and one.step.shape == ()
    assert tsde.sde_noise(tl, tls, one).shape == (B, ACT)
    again = tsde.maybe_resample(one, torch.Generator().manual_seed(1), 4)
    assert int(again.step) == 1 and not torch.equal(again.exploration_mat, one.exploration_mat)
    kept = tsde.maybe_resample(again, torch.Generator().manual_seed(2), 4)
    assert int(kept.step) == 2 and torch.equal(kept.exploration_mat, again.exploration_mat)


def test_converter_layout_and_round_trip():
    jnet, params, tnet = _actors(True)
    arrays = flatten(params)
    assert sorted(arrays) == [
        "params/MLP_0/dense_0/bias", "params/MLP_0/dense_0/kernel",
        "params/MLP_0/dense_1/bias", "params/MLP_0/dense_1/kernel",
        "params/log_std_sde", "params/mean/bias", "params/mean/kernel"]
    state = convert.state_dict_from_flax({**arrays, "__meta__": np.asarray("{}")})
    assert sorted(state) == sorted(tnet.state_dict())
    # a flax kernel is (in, out); an nn.Linear weight is (out, in)
    assert state["trunk.dense_0.weight"].shape == (32, OBS)
    np.testing.assert_array_equal(state["trunk.dense_0.weight"].numpy(),
                                  arrays["params/MLP_0/dense_0/kernel"].T)
    assert state["log_std_sde"].shape == (24, ACT)
    back = convert.state_dict_to_flax(tnet.state_dict())
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    # a missing or a surplus entry is an error at load time
    short = {k: v for k, v in state.items() if k != "mean.bias"}
    with pytest.raises(RuntimeError, match="mean.bias"):
        tnet.load_state_dict(short, strict=True)
    with pytest.raises(RuntimeError, match="log_std.weight"):
        tnet.load_state_dict({**state, "log_std.weight": torch.zeros(ACT, 24)}, strict=True)
    with pytest.raises(ValueError, match="params/"):
        convert.state_dict_from_flax({"opt/mean/bias": np.zeros(2)})
    # the PPO and critic layouts
    _, pparams, pnet = _ppo(False)
    assert sorted(convert.state_dict_from_flax(flatten(pparams))) == sorted(pnet.state_dict())
    assert "log_std" in pnet.state_dict() and "pi_trunk.dense_1.weight" in pnet.state_dict()
    assert "action_low" not in tnet.state_dict()  # bounds come from the metadata


def test_fresh_modules_start_like_flax():
    """Initializers: zero biases, the log-std constants, LeCun-normal kernels
    (std 1/sqrt(fan_in), none beyond two standard deviations of the parent)."""
    torch.manual_seed(0)
    actor = tmlp.SquashedGaussianActor(715, ACT)
    assert actor.hidden == (400, 300) and actor.log_std_init == -3.0 and not actor.use_sde
    assert (actor.trunk.dense_0.bias == 0).all() and (actor.mean.bias == 0).all()
    assert (actor.log_std.bias == -3.0).all()
    w = actor.trunk.dense_0.weight
    assert abs(float(w.detach().std()) * 715 ** 0.5 - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 / 0.87962566 / 715 ** 0.5 + 1e-6
    sde = tmlp.SquashedGaussianActor(OBS, ACT, use_sde=True)
    assert (sde.log_std_sde == -3.0).all() and sde.log_std_sde.shape == (300, ACT)
    ppo = tmlp.PpoActorCritic(OBS, ACT)
    assert ppo.pi_hidden == ppo.vf_hidden == (256, 256) and (ppo.log_std == -2.0).all()
    assert tmlp.PpoActorCritic(OBS, ACT, use_sde=True).log_std.shape == (256, ACT)
    q = tmlp.DoubleCritic(OBS, ACT)
    assert q.q1.dense_2.weight.shape == (1, 300) and q.q1.dense_0.weight.shape == (400, OBS + ACT)

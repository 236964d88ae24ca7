"""Plain reference of the SAC learner the ``sac_train`` traffic runs: the
reference's patched SB3 SAC (gym-usv ``train_test/config.py``) with gSDE
exploration and the CAPS smoothness terms, at the configuration's
``learner`` settings.

Networks are functions of a dict of named tensors: the actor is a ReLU trunk
(``trunk.dense_i``) with a linear mean head (``mean``) and a gSDE log-std
matrix (``log_std_sde``), whose marginal std is ``sqrt(phi^2 @ sigma^2 +
1e-6)``; each critic (``q1``, ``q2``) a ReLU MLP over ``[obs, action]``.
An update: the critic regresses on the soft target (the target critic, the
current temperature), the actor then minimises ``alpha * log pi - min Q``
under the UPDATED critic plus the CAPS temporal and spatial terms, the
temperature steps on the actor loss's mean log-prob, each by Adam, and the
target critic blends in ``tau`` of the new critic.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

LOG_2PI = math.log(2.0 * math.pi)


def layout(config: dict):
    """(network, parameter name, shape) of every parameter, in a fixed order."""
    L = config["learner"]
    obs = config["obs_dim"] * L["frame_stack"]
    act = len(config["action_low"])
    h = L["hidden"]
    out = [("actor", "log_std_sde", (h[-1], act))]
    dims = [obs, *h]
    for i in range(len(h)):
        out += [("actor", f"trunk.dense_{i}.weight", (dims[i + 1], dims[i])),
                ("actor", f"trunk.dense_{i}.bias", (dims[i + 1],))]
    out += [("actor", "mean.weight", (act, h[-1])), ("actor", "mean.bias", (act,))]
    dims = [obs + act, *h, 1]
    for q in ("q1", "q2"):
        for i in range(len(h) + 1):
            out += [("critic", f"{q}.dense_{i}.weight", (dims[i + 1], dims[i])),
                    ("critic", f"{q}.dense_{i}.bias", (dims[i + 1],))]
    return out


def make_weights(config: dict, generator: torch.Generator, device):
    """Initial weights from ``generator`` on ``device`` in one draw: each
    weight matrix normal with std 1/sqrt(fan in), clipped at two std; biases
    0; the gSDE log-std matrix at ``log_std_init``. -> {network: {name: tensor}}."""
    shapes = layout(config)
    mats = [(n, s) for _, n, s in shapes if n.endswith(".weight")]
    z = torch.randn(sum(math.prod(s) for _, s in mats), generator=generator, device=device)
    out, at = {"actor": {}, "critic": {}}, 0
    for net, name, shape in shapes:
        if name.endswith(".weight"):
            n = math.prod(shape)
            w = z[at:at + n].reshape(shape) / math.sqrt(shape[1])
            out[net][name] = torch.clamp(w, -2.0 / math.sqrt(shape[1]), 2.0 / math.sqrt(shape[1]))
            at += n
        elif name == "log_std_sde":
            out[net][name] = torch.full(shape, float(config["learner"]["log_std_init"]), device=device)
        else:
            out[net][name] = torch.zeros(shape, device=device)
    return out


def mlp(w, prefix, x, layers, activate_final):
    for i in range(layers):
        x = F.linear(x, w[f"{prefix}.dense_{i}.weight"], w[f"{prefix}.dense_{i}.bias"])
        if i < layers - 1 or activate_final:
            x = F.relu(x)
    return x


class Actor:
    def __init__(self, config):
        L = config["learner"]
        self.layers = len(L["hidden"])
        self.low = torch.tensor(config["action_low"])
        self.high = torch.tensor(config["action_high"])

    def _scale(self, a):
        low, high = self.low.to(a.device), self.high.to(a.device)
        return low + 0.5 * (a + 1.0) * (high - low)

    def trunk(self, w, obs):
        return mlp(w, "trunk", obs, self.layers, True)

    def forward(self, w, obs):
        """-> (mean, log std of the gSDE marginal, clipped to [-20, 2])."""
        phi = self.trunk(w, obs)
        mean = F.linear(phi, w["mean.weight"], w["mean.bias"])
        sigma2 = torch.exp(2.0 * torch.clamp(w["log_std_sde"], -20.0, 2.0))
        std = torch.sqrt(torch.einsum("bl,la->ba", torch.square(phi), sigma2) + 1e-6)
        return mean, torch.clamp(torch.log(std), -20.0, 2.0)

    def sample(self, w, obs, noise):
        """Reparameterised tanh-Gaussian sample -> (action, log prob, mean action)."""
        mean, log_std = self.forward(w, obs)
        squashed = torch.tanh(mean + torch.exp(log_std) * noise)
        logp = (-0.5 * (torch.square(noise) + 2.0 * log_std + LOG_2PI).sum(-1)
                - torch.log(1.0 - torch.square(squashed) + 1e-6).sum(-1))
        return self._scale(squashed), logp, self._scale(torch.tanh(mean))

    def deterministic(self, w, obs):
        return self._scale(torch.tanh(F.linear(self.trunk(w, obs), w["mean.weight"], w["mean.bias"])))

    def sample_sde(self, w, obs, exploration):
        """Collection: tanh(mean + phi @ (sigma * E)) with E (B, L, A)."""
        phi = self.trunk(w, obs)
        mean = F.linear(phi, w["mean.weight"], w["mean.bias"])
        sigma = torch.exp(torch.clamp(w["log_std_sde"], -20.0, 2.0))
        return self._scale(torch.tanh(mean + torch.einsum("bl,bla->ba", phi, sigma * exploration)))


def critic(config, w, obs, action):
    layers = len(config["learner"]["hidden"]) + 1
    x = torch.cat([obs, action], -1)
    return mlp(w, "q1", x, layers, False).squeeze(-1), mlp(w, "q2", x, layers, False).squeeze(-1)


class Adam:
    """Adam: m and v from zero (or from ``state``, ``{name: (m, v)}`` after
    ``t`` steps), bias-corrected, eps added to sqrt(v_hat)."""

    def __init__(self, params: dict, lr, b1, b2, eps, state=None, t=0):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, t
        state = state or {}
        zero = torch.zeros_like
        self.m = {k: state[k][0].clone() if k in state else zero(v) for k, v in params.items()}
        self.v = {k: state[k][1].clone() if k in state else zero(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        out = {}
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            m_hat = self.m[k] / (1.0 - self.b1 ** self.t)
            v_hat = self.v[k] / (1.0 - self.b2 ** self.t)
            out[k] = params[k] - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return out


class Learner:
    """The networks, the temperature and their optimizers -> :meth:`update`.

    ``leaves`` holds every trained tensor under :meth:`leaves`' names (the
    target critic as ``target.*``); ``adam``, where the learner starts after
    ``t`` updates, holds each optimized leaf's ``(m, v)`` under those names."""

    def __init__(self, config, leaves: dict, adam=None, t: int = 0):
        L = self.L = config["learner"]
        self.config, self.actor = config, Actor(config)
        self.w = {net: {k[len(net) + 1:]: v for k, v in leaves.items() if k.startswith(net + ".")}
                  for net in ("actor", "critic", "target")}
        self.log_alpha = leaves["log_alpha"]
        a, adam = L["adam"], adam or {}
        self.opt = {net: Adam(self.w[net], L["learning_rate"], a["b1"], a["b2"], a["eps"],
                              {k[len(net) + 1:]: v for k, v in adam.items()
                               if k.startswith(net + ".")}, t)
                    for net in ("actor", "critic")}
        self.opt["alpha"] = Adam({"log_alpha": self.log_alpha}, L["learning_rate"], a["b1"],
                                 a["b2"], a["eps"], adam, t)
        self.first_grads = None

    def update(self, batch, noise_next, noise_actor, noise_spatial):
        """One update -> (critic loss, actor loss); keeps the first update's
        gradients in ``first_grads``."""
        L, config = self.L, self.config
        w = self.w
        with torch.no_grad():
            next_a, next_logp, _ = self.actor.sample(w["actor"], batch["next_obs"], noise_next)
            q1_t, q2_t = critic(config, w["target"], batch["next_obs"], next_a)
            target_v = torch.minimum(q1_t, q2_t) - torch.exp(self.log_alpha) * next_logp
            target_q = batch["reward"] + L["gamma"] * (1.0 - batch["done"]) * target_v
        cw = {k: v.detach().requires_grad_(True) for k, v in w["critic"].items()}
        q1, q2 = critic(config, cw, batch["obs"], batch["action"])
        critic_loss = 0.5 * (torch.square(q1 - target_q).mean() + torch.square(q2 - target_q).mean())
        g_critic = dict(zip(cw, torch.autograd.grad(critic_loss, list(cw.values()))))
        w["critic"] = self.opt["critic"].step(w["critic"], g_critic)

        aw = {k: v.detach().requires_grad_(True) for k, v in w["actor"].items()}
        action, logp, mu = self.actor.sample(aw, batch["obs"], noise_actor)
        q1, q2 = critic(config, w["critic"], batch["obs"], action)
        alpha = torch.exp(self.log_alpha)
        sac_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
        mu_next = self.actor.deterministic(aw, batch["next_obs"])
        mu_noisy = self.actor.deterministic(aw, batch["obs"] + L["eps_s"] * noise_spatial)
        caps_t = torch.square(mu - mu_next).sum(-1).mean()
        caps_s = torch.square(mu - mu_noisy).sum(-1).mean()
        actor_loss = sac_loss + L["lambda_t"] * caps_t + L["lambda_s"] * caps_s
        g_actor = dict(zip(aw, torch.autograd.grad(actor_loss, list(aw.values()))))
        w["actor"] = self.opt["actor"].step(w["actor"], g_actor)

        g_alpha = -(logp.detach().mean() + L["target_entropy"])
        self.log_alpha = self.opt["alpha"].step({"log_alpha": self.log_alpha},
                                                {"log_alpha": g_alpha})["log_alpha"]
        w["target"] = {k: v * (1.0 - L["tau"]) + L["tau"] * w["critic"][k]
                       for k, v in w["target"].items()}
        if self.first_grads is None:
            self.first_grads = {**{"actor." + k: v for k, v in g_actor.items()},
                                **{"critic." + k: v for k, v in g_critic.items()},
                                "log_alpha": g_alpha}
        return critic_loss.detach(), actor_loss.detach()

    def leaves(self) -> dict:
        """Every trained tensor under one name: actor.*, critic.*, target.*, log_alpha."""
        out = {f"{net}.{k}": v for net in ("actor", "critic", "target") for k, v in self.w[net].items()}
        out["log_alpha"] = self.log_alpha
        return out

    def first_moments(self) -> dict:
        """Each optimized leaf's Adam first moment, under :meth:`leaves`' names."""
        out = {f"{net}.{k}": v for net in ("actor", "critic") for k, v in self.opt[net].m.items()}
        out["log_alpha"] = self.opt["alpha"].m["log_alpha"]
        return out

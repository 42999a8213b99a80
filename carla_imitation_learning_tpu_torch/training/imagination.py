"""A driving policy trained in a world model's imagination (the JAX
package's ``training/imagination.py``).

A reward head is fitted on real-frame latents and the driving reward
recorded with them; a small latent policy is then trained inside the
frozen ``LatentWorldModel``: from real latents, H imagined steps of policy
→ reward → latent dynamics, and the discounted return maximised by
backpropagating through the reward head and the dynamics. Discrete models
get straight-through Gumbel-softmax actions (one-hot forward, relaxed
gradient); continuous models get the tanh controls plus Gaussian
exploration noise. Against exploitation of the model: an ensemble of heads
with the reward lowered by ``disagree_coef`` × their spread, imagination
stopped per row once the spread passes ``uncertainty_stop``, and a KL (or,
for controls, squared-distance) anchor to a latent-BC policy
(``train_latent_bc``), which can also warm-start the policy. The result is
driven in the real sim through ``latent_policy_fn``.

Every random draw goes through a hook a test can feed: ``init_module``
(flax's initializer), ``draw_indices`` (minibatch rows), ``draw_gumbel``
and ``draw_normal``. Optimisers are ``torch.optim.Adam`` with optax's
defaults (eps 1e-8, no clip).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from carla_imitation_learning_tpu_torch.models.world_model import LatentWorldModel
from carla_imitation_learning_tpu_torch.training.steps import ADAM_BETAS, ADAM_EPS, flax_init_


class RewardHead(nn.Module):
    """z → r̂, the dense driving reward of the state that produced z."""

    def __init__(self, z_size: int, hidden: int = 64):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(z_size, hidden), nn.Linear(hidden, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(z)))[..., 0]


class LatentPolicy(nn.Module):
    """z → action logits: all perception lives in the world model's encoder."""

    def __init__(self, z_size: int, n_actions: int = 9, hidden: int = 64):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(z_size, hidden), nn.Linear(hidden, n_actions)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(z)))


class ContinuousLatentPolicy(nn.Module):
    """z → tanh (steer, accel) for a continuous-conditioned world model."""

    def __init__(self, z_size: int, hidden: int = 64):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(z_size, hidden), nn.Linear(hidden, 2)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.fc2(F.relu(self.fc1(z))))


class HeadEnsemble(nn.Module):
    """E reward heads with their weights stacked on a leading axis, run as
    one batched product: on (B, z) latents every head sees the same rows,
    on (E, B, z) head e sees row block e. → (E, B) rewards."""

    def __init__(self, members: list[RewardHead]):
        super().__init__()
        self.k = len(members)
        for name, key in (("weight1", "fc1.weight"), ("bias1", "fc1.bias"),
                          ("weight2", "fc2.weight"), ("bias2", "fc2.bias")):
            setattr(self, name, nn.Parameter(torch.stack(
                [m.state_dict()[key].detach() for m in members])))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        rows = "ebz" if z.dim() == 3 else "bz"
        h = F.relu(torch.einsum(f"{rows},ehz->ebh", z, self.weight1) + self.bias1[:, None])
        return (torch.einsum("ebh,eoh->ebo", h, self.weight2) + self.bias2[:, None])[..., 0]


# -- the draws ---------------------------------------------------------------

def init_module(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """A fresh module's weights, drawn as flax's defaults (``flax_init_``;
    ``generator`` is a CPU generator)."""
    return flax_init_(module, generator)


def draw_indices(generator: torch.Generator, shape: tuple, n: int,
                 device: torch.device) -> torch.Tensor:
    """Minibatch rows, uniform in [0, n), drawn on the generator's device."""
    return torch.randint(0, n, shape, generator=generator,
                         device=generator.device).to(device)


def draw_gumbel(generator: torch.Generator, shape: tuple, device: torch.device) -> torch.Tensor:
    """Gumbel(0, 1) noise −log(−log u), u uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=generator.device).clamp(min=tiny)
    return (-torch.log(-torch.log(u))).to(device)


def draw_normal(generator: torch.Generator, shape: tuple, device: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def _adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def _logged(s: int, steps: int) -> bool:
    return s % max(1, steps // 10) == 0 or s == steps - 1


# -- the frozen world model ---------------------------------------------------

@torch.no_grad()
def encode_frames(wm: LatentWorldModel, frames: torch.Tensor, batch: int = 512) -> torch.Tensor:
    """(N, H, W, C) float frames → (N, z) latents, in chunks of ``batch``."""
    return torch.cat([wm.encoder(frames[i:i + batch])
                      for i in range(0, frames.shape[0], batch)])


def train_reward_head(zs: torch.Tensor, rewards: torch.Tensor, generator: torch.Generator,
                      init_generator: torch.Generator, *, steps: int = 300, batch: int = 256,
                      lr: float = 1e-3, hidden: int = 64, ensemble: int = 1):
    """Fit a ``RewardHead`` on (latent, recorded reward) pairs by Adam on
    the minibatch MSE. ``ensemble > 1`` trains E heads with their own
    initial weights and their own bootstrap rows each step, stacked in a
    ``HeadEnsemble`` and updated by one Adam (each head's gradient that of
    its own MSE); their disagreement is the imagination's uncertainty.
    → (head or ensemble, history of the mean MSE at every tenth step and
    the last)."""
    dev, n = zs.device, zs.shape[0]
    members = [init_module(RewardHead(zs.shape[1], hidden), init_generator).to(dev)
               for _ in range(max(1, ensemble))]
    head = HeadEnsemble(members) if ensemble > 1 else members[0]
    opt = _adam(head.parameters(), lr)
    idx_shape = (ensemble, min(batch, n)) if ensemble > 1 else (min(batch, n),)
    history = []
    for s in range(steps):
        idx = draw_indices(generator, idx_shape, n, dev)
        mse = ((head(zs[idx]) - rewards[idx]) ** 2).mean(-1)
        opt.zero_grad(set_to_none=True)
        mse.sum().backward()
        opt.step()
        if _logged(s, steps):
            history.append(float(mse.detach().mean()))
    return head.requires_grad_(False), history


def train_latent_bc(policy: nn.Module, zs: torch.Tensor, targets: torch.Tensor,
                    generator: torch.Generator, init_generator: torch.Generator, *,
                    steps: int = 300, batch: int = 256, lr: float = 1e-3,
                    continuous: bool = False):
    """Behaviour cloning in latent space: ``policy`` (fresh weights drawn
    here) fitted on (z, expert action) pairs, CE on (N,) action ids or MSE
    on (N, 2) controls. It warm-starts the imagination policy and anchors
    it. → (policy, history of the loss at every tenth step and the last)."""
    dev, n = zs.device, zs.shape[0]
    policy = init_module(policy, init_generator).to(dev)
    opt = _adam(policy.parameters(), lr)
    history = []
    for s in range(steps):
        idx = draw_indices(generator, (min(batch, n),), n, dev)
        out = policy(zs[idx])
        if continuous:
            loss = ((out - targets[idx]) ** 2).mean()
        else:
            logp = F.log_softmax(out, dim=-1)
            loss = -logp.gather(-1, targets[idx].to(torch.int64)[:, None]).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if _logged(s, steps):
            history.append(float(loss.detach()))
    return policy, history


def make_imagination_update(
    wm: LatentWorldModel, head, policy: nn.Module, optimizer: torch.optim.Optimizer, *,
    horizon: int = 15, gamma: float = 0.98, temperature: float = 1.0,
    entropy_coef: float = 3e-3, explore_std: float = 0.1, disagree_coef: float = 0.0,
    anchor: nn.Module | None = None, anchor_coef: float = 0.0,
    uncertainty_stop: float = 0.0,
) -> Callable:
    """``update(z0 (B, z), generator) -> metrics``: one Adam step of
    ``policy`` on the negated imagined return (plus the entropy bonus and
    the anchor penalty), through the frozen ``wm`` and ``head`` (a
    ``HeadEnsemble`` applies the disagreement penalty and the uncertainty
    stop; a single head has zero spread). ``anchor`` is the frozen
    latent-BC policy. Metrics (device tensors): ``imagined_return``,
    ``entropy``, ``anchor_kl``, ``reward_std``, ``alive_frac``, ``loss``."""
    continuous = wm.action_space == "continuous"
    wm.requires_grad_(False)
    head.requires_grad_(False)
    ensemble = isinstance(head, HeadEnsemble)

    def step_reward(z):
        if ensemble:
            rs = head(z)
            std = rs.std(dim=0, correction=0)
            return rs.mean(0) - disagree_coef * std, std
        r = head(z)
        return r, torch.zeros_like(r)

    def imagined_loss(z0, generator):
        dev = z0.device
        carry, z = wm.initial_carry(z0.shape[0], dev), z0
        alive = torch.ones(z0.shape[0], device=dev)
        rs, ents, anchors, stds, alives = [], [], [], [], []
        zero = torch.zeros((), device=dev)
        for _ in range(horizon):
            out = policy(z)
            anchor_t = zero
            if continuous:
                noise = explore_std * draw_normal(generator, tuple(out.shape), dev)
                a = torch.clamp(out + noise, -1.0, 1.0)
                entropy = zero
                if anchor is not None:
                    ref = anchor(z).detach()
                    anchor_t = ((out - ref) ** 2).sum(-1).mean()
            else:
                logp = F.log_softmax(out, dim=-1)
                g = draw_gumbel(generator, tuple(out.shape), dev)
                y = F.softmax((out + g) / temperature, dim=-1)
                hard = F.one_hot(y.argmax(-1), out.shape[-1]).to(y.dtype)
                a = hard + y - y.detach()
                entropy = -(logp.exp() * logp).sum(-1).mean()
                if anchor is not None:
                    ref_logp = F.log_softmax(anchor(z).detach(), dim=-1)
                    anchor_t = (logp.exp() * (logp - ref_logp)).sum(-1).mean()
            r, std = step_reward(z)
            alive_next = (alive * (std < uncertainty_stop).to(alive.dtype)
                          if uncertainty_stop > 0.0 else alive)
            carry, z = wm.dynamics_step(carry, z, a)
            rs.append(r * alive)
            ents.append(entropy)
            anchors.append(anchor_t)
            stds.append(std.mean())
            alives.append(alive.mean())
            alive = alive_next
        disc = gamma ** torch.arange(horizon, dtype=torch.float32, device=dev)
        ret = (torch.stack(rs) * disc[:, None]).sum(0).mean()
        entropy, anchor_kl = torch.stack(ents).mean(), torch.stack(anchors).mean()
        loss = -(ret + entropy_coef * entropy) + anchor_coef * anchor_kl
        return loss, {"imagined_return": ret.detach(), "entropy": entropy.detach(),
                      "anchor_kl": anchor_kl.detach(),
                      "reward_std": torch.stack(stds).mean().detach(),
                      "alive_frac": torch.stack(alives).mean()}

    def update(z0: torch.Tensor, generator: torch.Generator) -> dict:
        loss, metrics = imagined_loss(z0, generator)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        metrics["loss"] = loss.detach()
        return metrics

    return update


def latent_policy_fn(wm: LatentWorldModel, policy: nn.Module) -> Callable:
    """The real-sim adapter: the rollout's (B, H, W, fs) window → its newest
    frame → the world model's latent → the latent policy's argmax (or, for
    a continuous model, its controls: run it with
    ``control_space="continuous"``)."""
    continuous = wm.action_space == "continuous"

    @torch.no_grad()
    def policy_fn(obs):
        out = policy(wm.encoder(obs[..., -1:]))
        return out if continuous else out.argmax(-1)

    return policy_fn


def imagination_train(
    wm: LatentWorldModel, head, zs_start: torch.Tensor, generator: torch.Generator,
    init_generator: torch.Generator, *, updates: int = 300, batch: int = 128,
    horizon: int = 15, gamma: float = 0.98, lr: float = 3e-4, entropy_coef: float = 3e-3,
    hidden: int = 64, explore_std: float = 0.1, disagree_coef: float = 0.0,
    anchor: nn.Module | None = None, anchor_coef: float = 0.0,
    init: nn.Module | None = None, uncertainty_stop: float = 0.0,
):
    """Train a latent policy purely in imagination from rows of real
    latents ``zs_start``: ``LatentPolicy`` for a discrete model,
    ``ContinuousLatentPolicy`` for a continuous one, fresh or a copy of
    ``init``'s weights (the latent-BC warm start). → (policy, history of
    metric dicts at every tenth update and the last)."""
    dev, n, z_size = zs_start.device, zs_start.shape[0], zs_start.shape[1]
    policy = (ContinuousLatentPolicy(z_size, hidden) if wm.action_space == "continuous"
              else LatentPolicy(z_size, wm.n_actions, hidden))
    if init is not None:
        policy.load_state_dict(init.state_dict())
        policy = policy.to(dev)
    else:
        policy = init_module(policy, init_generator).to(dev)
    opt = _adam(policy.parameters(), lr)
    update = make_imagination_update(
        wm, head, policy, opt, horizon=horizon, gamma=gamma, entropy_coef=entropy_coef,
        explore_std=explore_std, disagree_coef=disagree_coef, anchor=anchor,
        anchor_coef=anchor_coef, uncertainty_stop=uncertainty_stop)
    history = []
    for s in range(updates):
        idx = draw_indices(generator, (min(batch, n),), n, dev)
        metrics = update(zs_start[idx], generator)
        if _logged(s, updates):
            history.append({"update": s, **{k: float(v) for k, v in metrics.items()}})
    return policy, history

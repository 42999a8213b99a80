"""PPO fine-tuning of driving policies (the JAX package's ``training/rl.py``).

The PPO rollout is ``make_rollout`` itself, driven by a stochastic actor
(``make_actor``) that draws from the rollout's per-step generator and logs
its log-probability and value through the ``policy_extra`` channel; so the
policy trains against exactly the physics and renderer (kernel B) it is
evaluated on. Observations are not stored four times over: the update
rebuilds each step's 4-frame window from the trajectory's frames and episode
ends (``window_sources``, the exact ``update_framebuf`` semantics) by
gathers. Rewards come from the signals the evaluator scores: along-route
progress minus collision, red-light and off-road penalties.

Random draws go through two hooks, ``actor_draws`` (the actor's Gumbel or
normal noise) and ``epoch_permutations`` (each epoch's per-env step
orders), so a test can feed them the JAX package's draws.

Data parallel (``ppo_train(mesh=)``, the JAX package's env-axis sharding
of the rollout and the update): each rank steps and renders its ``B / n``
envs and updates on its envs' steps. Every draw is the global fleet's,
each rank keeping its rows (the fleet's reset, the actor's noise, each
epoch's permutations), so the ranks run the global program: the
advantages are normalised by the global mean and population std (two
all-reduces), a minibatch's gradient is the mean over ranks of their
equal-sized row means before the clip, and the metrics are global means.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from carla_imitation_learning_tpu_torch.models.cnn import ConvTrunk, MLPHead
from carla_imitation_learning_tpu_torch.training.steps import TrainState

LOG_2PI = 1.8378770664093453
LOG_STD_INIT = -0.7


class ActorCriticCNN(nn.Module):
    """``PolicyCNN``'s trunk and head (state-dict names ``trunk.*`` and
    ``head.*``, so a ``bc`` checkpoint warm-starts the actor by key copy)
    plus a 128→64→32→1 critic (``critic.*``): (B, H, W, obs_size) →
    (logits (B, n_actions), value (B,)).

    ``continuous=True`` is the diagonal-Gaussian actor over (steer, accel):
    the mean is ``tanh`` of a 2-way head, ``ContinuousPolicyCNN``'s output
    (a ``bc_continuous`` checkpoint warm-starts it alike), with a
    state-independent float32 ``log_std`` (2,) from −0.7; the output is then
    ((mean, log_std), value)."""

    def __init__(self, obs_size: int = 4, n_actions: int = 9,
                 dtype: torch.dtype = torch.bfloat16, s2d_stem: bool = False,
                 continuous: bool = False):
        super().__init__()
        self.continuous = continuous
        self.trunk = ConvTrunk(in_channels=obs_size, dtype=dtype, s2d_stem=s2d_stem)
        self.head = MLPHead(128, (64, 32, 2 if continuous else n_actions), dtype=dtype)
        self.critic = MLPHead(128, (64, 32, 1), dtype=dtype)
        if continuous:
            self.log_std = nn.Parameter(torch.full((2,), LOG_STD_INIT))

    def forward(self, x: torch.Tensor):
        feat = self.trunk(x)
        value = self.critic(feat)[..., 0]
        if self.continuous:
            return (torch.tanh(self.head(feat)), self.log_std), value
        return self.head(feat), value


def warm_start_from_policy(ac: ActorCriticCNN, policy: nn.Module) -> ActorCriticCNN:
    """Copy a trained ``PolicyCNN`` / ``ContinuousPolicyCNN``'s trunk and
    head into ``ac`` in place (the critic and ``log_std`` stay fresh)."""
    ac.load_state_dict({**ac.state_dict(), **policy.state_dict()})
    return ac


def actor_policy_params_from(ac: ActorCriticCNN) -> dict:
    """The actor as a ``PolicyCNN``-shaped state dict (``trunk.*`` and
    ``head.*``; ``ContinuousPolicyCNN``'s for the Gaussian actor)."""
    return {k: v for k, v in ac.state_dict().items() if k.startswith(("trunk.", "head."))}


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    # reward weights: progress in meters along the route per step; penalties
    # per discrete event, one collision cancelling about 25 m of progress
    w_progress: float = 1.0
    w_collision: float = 25.0
    w_red: float = 10.0
    w_offroad: float = 10.0
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    update_epochs: int = 4
    num_minibatches: int = 8
    learning_rate: float = 3e-4
    max_grad_norm: float = 0.5
    normalize_advantages: bool = True


def reward_from_traj(traj: dict, cfg: PPOConfig) -> torch.Tensor:
    """(T, B) reward: ``w_progress`` · along-route meters, less the
    collision, off-road and red-light-crossing (``traj["ran_red"]``, the
    evaluator's event) penalties."""
    return (cfg.w_progress * traj["route_ds"]
            - cfg.w_collision * traj["collision"].to(torch.float32)
            - cfg.w_red * traj["ran_red"].to(torch.float32)
            - cfg.w_offroad * traj["offroad"].to(torch.float32))


def compute_gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
                last_value: torch.Tensor, gamma: float, lam: float):
    """Generalized advantage estimation over (T, B): ``dones[t]`` marks a
    step that ended an episode, which cuts the bootstrap there. →
    (advantages, returns), each (T, B)."""
    adv = torch.empty_like(rewards)
    gae, value_next = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + gamma * value_next * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        value_next = values[t]
    return adv, adv + values


def window_sources(dones: torch.Tensor, frame_skip: int = 4) -> torch.Tensor:
    """(T, B) dones → (T, B, frame_skip) indices of the stored frames that
    make each step's window, oldest first: frames t−k+1..t, floored at the
    last refill (the step after an episode end, and step 0, where a rollout
    of ``ppo_train`` always refills)."""
    n_steps, n_envs = dones.shape
    t_idx = torch.arange(n_steps, device=dones.device)[:, None]
    just_reset = torch.cat([torch.ones(1, n_envs, dtype=torch.bool, device=dones.device),
                            dones[:-1].to(torch.bool)], dim=0)
    floor = torch.cummax(torch.where(just_reset, t_idx, 0), dim=0).values
    offsets = torch.arange(frame_skip - 1, -1, -1, device=dones.device)
    return torch.maximum(t_idx[..., None] - offsets, floor[..., None])


def gather_windows(gray: torch.Tensor, src: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Observation windows of flat transition indices ``t·B + b``: gray (T,
    B, H, W) uint8, src from ``window_sources`` → (m, H, W, k) float32 in
    [0, 1]."""
    n_envs = gray.shape[1]
    t, b = flat_idx // n_envs, flat_idx % n_envs
    w = gray[src[t, b], b[:, None]]                      # (m, k, H, W)
    return w.permute(0, 2, 3, 1).to(torch.float32) * (1.0 / 255.0)


def gaussian_logp(a: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor) -> torch.Tensor:
    """Σ_d log N(a_d | μ_d, σ_d) over the last axis."""
    z = (a - mean) * torch.exp(-log_std)
    return (-0.5 * (z * z + LOG_2PI) - log_std).sum(dim=-1)


def actor_draws(generator: torch.Generator, shape: tuple, continuous: bool,
                device: torch.device) -> torch.Tensor:
    """The actor's noise for one step, drawn on the generator's device and
    moved to ``device``: standard normal (the Gaussian actor), or Gumbel(0,
    1) = −log(−log u), u uniform in [tiny, 1) (the categorical sample is the
    argmax of logits plus this noise, as ``jax.random.categorical``)."""
    if continuous:
        return torch.randn(shape, generator=generator, device=generator.device).to(device)
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def epoch_permutations(generator: torch.Generator, n_envs: int, n_steps: int,
                       device: torch.device) -> torch.Tensor:
    """(n_envs, n_steps) int64: one permutation of the steps per env for an
    update epoch, drawn on the generator's device."""
    keys = torch.rand(n_envs, n_steps, generator=generator, device=generator.device)
    return torch.argsort(keys, dim=1).to(device)


def make_actor(model: ActorCriticCNN, sample: bool = True, mesh=None) -> Callable:
    """``policy_fn(obs, extras, params)`` for ``make_rollout``: ``params``
    is the module to run (``model`` when None), the draw comes from
    ``extras["rng"]`` through ``actor_draws``. ``sample=False`` is the
    deterministic actor (argmax, or the Gaussian mean). Under a ``mesh``
    (``obs`` a rank's rows of the fleet) each draw is the global fleet's,
    of which the rank keeps its rows.

    Discrete: → (action (B,) int64, extra (B, 2) = (logp, value)).
    Continuous: → (raw (B, 2), extra (B, 4) = (raw a0, raw a1, logp,
    value)): the unclipped draw, on which PPO's ratios are computed, while
    the rollout executes it clipped to the unit square (run it with
    ``control_space="continuous"``)."""

    def draws(extras, like: torch.Tensor, continuous: bool) -> torch.Tensor:
        if mesh is None:
            return actor_draws(extras["rng"], tuple(like.shape), continuous, like.device)
        n = like.shape[0] * mesh.size()
        return actor_draws(extras["rng"], (n,) + tuple(like.shape[1:]), continuous,
                           like.device)[mesh.rows(n)]

    def policy_fn(obs, extras, params=None):
        net = model if params is None else params
        if net.continuous:
            (mean, log_std), value = net(obs)
            raw = mean
            if sample:
                raw = mean + torch.exp(log_std) * draws(extras, mean, True)
            lp = gaussian_logp(raw, mean, log_std)
            return raw, torch.cat([raw, torch.stack([lp, value.to(torch.float32)], -1)], -1)
        logits, value = net(obs)
        if sample:
            action = torch.argmax(logits + draws(extras, logits, False), dim=-1)
        else:
            action = torch.argmax(logits, dim=-1)
        lp = F.log_softmax(logits, dim=-1).gather(-1, action[:, None])[:, 0]
        return action, torch.stack([lp, value.to(torch.float32)], -1)

    return policy_fn


def ppo_loss_fn(cfg: PPOConfig):
    """The clipped-surrogate loss as ``loss_fn(model, batch, generator=None)
    -> (loss, stats)``, batch = (obs, action, old_logp, adv, ret,
    old_value): the policy-gradient term, ``value_coef`` × the clipped value
    loss (PPO2 form) and −``entropy_coef`` × the entropy (the batch mean of
    −Σ p log p for the categorical actor; the Gaussian's closed form summed
    over its two dims)."""

    def loss_fn(model, batch, generator: torch.Generator | None = None):
        obs, action, old_logp, adv, ret, old_value = batch
        if model.continuous:
            (mean, log_std), value = model(obs)
            logp = gaussian_logp(action, mean, log_std)
            entropy = (log_std + 0.5 * (1.0 + LOG_2PI)).sum()
        else:
            logits, value = model(obs)
            logp_all = F.log_softmax(logits, dim=-1)
            logp = logp_all.gather(-1, action[:, None].to(torch.int64))[:, 0]
            entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        ratio = torch.exp(logp - old_logp)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -torch.mean(torch.minimum(pg1, pg2))
        v_clip = old_value + torch.clamp(value - old_value, -cfg.clip_eps, cfg.clip_eps)
        v_loss = 0.5 * torch.mean(torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2))
        total = pg_loss + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
        stats = {"pg_loss": pg_loss, "value_loss": v_loss, "entropy": entropy,
                 "approx_kl": torch.mean(old_logp - logp),
                 "clip_frac": torch.mean(((ratio - 1).abs() > cfg.clip_eps).to(torch.float32))}
        return total, {k: v.detach() for k, v in stats.items()}

    return loss_fn


def normalize_advantages(adv: torch.Tensor, mesh=None) -> torch.Tensor:
    """(adv − mean) / (population std + 1e-8) over the whole (T, B); under
    a ``mesh`` (B a rank's columns) over the global fleet's, in two passes
    in float32: the all-reduced sum, then the all-reduced sum of squared
    deviations."""
    if mesh is None or mesh.size() == 1:
        return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    n = adv.numel() * mesh.size()
    mean = mesh.all_reduce_(adv.sum().reshape(1)) / n
    var = mesh.all_reduce_(((adv - mean) ** 2).sum().reshape(1)) / n
    return (adv - mean) / (torch.sqrt(var) + 1e-8)


def make_ppo_update(state: TrainState, cfg: PPOConfig, frame_skip: int = 4):
    """``update(traj, last_value, generator) -> metrics`` (device scalars):
    GAE on the rollout's rewards, then ``update_epochs`` × ``num_minibatches``
    clipped-surrogate steps of ``state`` (Adam behind the global-norm clip).
    Minibatches are stratified by env: each epoch draws a permutation of
    the T steps per env (``epoch_permutations``), its first mt · M entries
    (mt = T // M) split into M minibatches of mt steps from every env, and
    the windows flattened b-major to (B·mt, H, W, k). A state replicated
    over a mesh (``shard_train_state``; ``traj`` the rank's envs) updates
    data-parallel: see the module's docstring."""
    loss_fn = ppo_loss_fn(cfg)
    continuous = state.model.continuous
    mesh = state.mesh

    def update(traj: dict, last_value: torch.Tensor, generator: torch.Generator) -> dict:
        n_steps, n_envs = traj["action"].shape[:2]
        n_global = n_envs if mesh is None else n_envs * mesh.size()
        rows = slice(None) if mesh is None else mesh.rows(n_global)
        height, width = traj["gray"].shape[2:]
        dev = traj["gray"].device
        rewards = reward_from_traj(traj, cfg)
        extra = traj["policy_extra"]                      # (T, B, 2 | 4)
        old_logp, values = extra[..., -2], extra[..., -1]
        act_field = extra[..., :2] if continuous else traj["action"]
        adv, ret = compute_gae(rewards, values, traj["done"], last_value, cfg.gamma,
                               cfg.gae_lambda)
        if cfg.normalize_advantages:
            adv = normalize_advantages(adv, mesh)
        src = window_sources(traj["done"], frame_skip)
        mt = n_steps // cfg.num_minibatches
        if mt == 0:
            raise ValueError(f"rollout_steps={n_steps} < num_minibatches={cfg.num_minibatches}")
        fields = (act_field, old_logp, adv, ret, values)
        env = torch.arange(n_envs, device=dev)[:, None]   # (B, 1)
        stats = []
        for _ in range(cfg.update_epochs):
            perm = epoch_permutations(generator, n_global, n_steps, dev)[rows]
            perm = perm[:, :mt * cfg.num_minibatches].reshape(
                n_envs, cfg.num_minibatches, mt).transpose(0, 1)       # (M, B, mt)
            for t_sel in perm:
                w = traj["gray"][src[t_sel, env], env[..., None]]       # (B, mt, k, H, W)
                obs = w.permute(0, 1, 3, 4, 2).reshape(
                    n_envs * mt, height, width, frame_skip).to(torch.float32) * (1.0 / 255.0)
                batch = (obs,) + tuple(f[t_sel, env].reshape((n_envs * mt,) + f.shape[2:])
                                       for f in fields)
                state.optimizer.zero_grad(set_to_none=True)
                loss, s = loss_fn(state.model, batch)
                loss.backward()
                state.apply_gradients()
                s["loss"] = loss.detach()
                stats.append(s)
        metrics = {k: torch.stack([s[k] for s in stats]).mean() for k in stats[0]}
        metrics["reward_per_step"] = rewards.mean()
        metrics["progress_m_per_step"] = traj["route_ds"].mean()
        metrics["value_mean"] = values.mean()
        metrics["ran_red_per_1k_steps"] = 1e3 * traj["ran_red"].to(torch.float32).mean()
        metrics["collisions_per_1k_steps"] = 1e3 * traj["collision"].to(torch.float32).mean()
        return metrics if mesh is None else mesh.mean_metrics(metrics)

    return update


@torch.no_grad()
def bootstrap_value(model: ActorCriticCNN, carry) -> torch.Tensor:
    """V of the final carry's window (one frame short of what step T+1
    would render), zeroed where the last step ended an episode."""
    _, framebuf, just_reset = carry
    _, value = model(framebuf.to(torch.float32) * (1.0 / 255.0))
    return torch.where(just_reset, 0.0, value.to(torch.float32))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ppo_train(sim_params, town, rcfg, state: TrainState, generator: torch.Generator, *,
              n_envs: int, rollout_steps: int, iterations: int, cfg: PPOConfig | None = None,
              frame_skip: int = 4, on_iteration: Callable | None = None,
              device: str | torch.device = "cuda", mesh=None):
    """PPO: fleet rollouts (the env state persists across iterations) and
    updates, alternating, on ``state`` (an ``ActorCriticCNN``'s train
    state, updated in place). ``generator`` (a CPU generator) draws the
    fleet's start and seeds the device generators of the actor's draws and
    the epochs' permutations. Every rollout starts with a forced window
    refill, so the update's windows never need a frame from before it. →
    history: per iteration the update's metrics as host floats, with
    ``seconds``, ``env_steps_per_sec``, and ``rollout_seconds`` and
    ``update_seconds`` (each ended by a device sync);
    ``on_iteration(i, metrics)`` is called with each. ``mesh`` shards the
    fleet of ``n_envs`` (which must divide over it) and replicates
    ``state`` (``shard_train_state``); the metrics, and
    ``env_steps_per_sec``, are the global fleet's on every rank."""
    from carla_imitation_learning_tpu_torch.device import resolve_device
    from carla_imitation_learning_tpu_torch.parallel.mesh import shard_train_state
    from carla_imitation_learning_tpu_torch.training import closed_loop as cl

    cfg = cfg or PPOConfig()
    dev = resolve_device(device)
    if mesh is not None and state.mesh is None:
        state = shard_train_state(mesh, state)
    model = state.model
    seeds = torch.randint(0, 2 ** 62, (2,), generator=generator).tolist()
    policy_gen = torch.Generator(device=dev).manual_seed(seeds[0])
    update_gen = torch.Generator(device=dev).manual_seed(seeds[1])
    init_fn, rollout_fn = cl.make_rollout(
        sim_params, town, rcfg, make_actor(model, sample=True, mesh=mesh), frame_skip,
        device=dev, policy_rng=policy_gen, mesh=mesh,
        control_space="continuous" if model.continuous else "discrete")
    update = make_ppo_update(state, cfg, frame_skip)
    carry = init_fn(generator, n_envs)
    n_local = carry[0].t.shape[0]
    history = []
    for i in range(iterations):
        t0 = time.perf_counter()
        states, framebuf, _ = carry
        carry = (states, framebuf, torch.ones(n_local, dtype=torch.bool, device=dev))
        carry, traj = rollout_fn(carry, rollout_steps, policy_params=model)
        _sync(dev)
        t1 = time.perf_counter()
        metrics = update(traj, bootstrap_value(model, carry), update_gen)
        del traj
        host = {k: float(v) for k, v in metrics.items()}
        t2 = time.perf_counter()
        host.update(iteration=i, seconds=t2 - t0,
                    env_steps_per_sec=n_envs * rollout_steps / (t2 - t0),
                    rollout_seconds=t1 - t0, update_seconds=t2 - t1)
        history.append(host)
        if on_iteration is not None:
            on_iteration(i, host)
    return state, history

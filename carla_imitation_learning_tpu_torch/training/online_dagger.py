"""Online DAgger with a card-resident aggregation buffer (the JAX package's
``training/online_dagger.py``).

The JAX package compiles the whole loop — R rounds of (β-mixed rollout →
buffer write → K sampled train steps) — into one XLA program. Here each
piece is a batch of tensor ops on the card and the loop runs on the host,
but nothing leaves the card until the per-round metrics are read once at
the end: the frames, labels and dones of every round live in one
(R, T, B, ...) buffer and training batches are gathers from it.

Algorithm (Ross, Gordon & Bagnell 2011): at round r the executed action is
the expert's with probability β_r = beta**r and the policy's otherwise; the
stored label is always the expert's. beta=0.0 gives the classic schedule
(an expert round 0, since 0**0 == 1, then the policy alone). Both drive
through the 9-class discretizer, so round 0 executes the expert's
discretized control.

Sampling is stratified by env: every env contributes ``batch // n_envs``
windows (at least one) per train step, from rounds ≤ r. A window whose
start lies before the trajectory, or that holds an auto-reset between its
frames, gets weight 0 in the masked cross-entropy rather than being drawn
again. Its frames are still gathered (from the start ``lax.dynamic_slice``
gives it), so every term stays finite.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from carla_imitation_learning_tpu_torch.data.actions import continuous_to_discrete
from carla_imitation_learning_tpu_torch.device import resolve_device
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_renderer
from carla_imitation_learning_tpu_torch.sim.town import TownMap
from carla_imitation_learning_tpu_torch.sim.world import (
    SimParams, autopilot_control, navigation_command, pick_fresh_packed, reset_env,
    step_env,
)
from carla_imitation_learning_tpu_torch.training.closed_loop import (
    control_from_discrete, rollout_spawn_pool, update_framebuf,
)
from carla_imitation_learning_tpu_torch.training.steps import TrainState


def window_indices(generator: torch.Generator, r: int, rounds: int, n_steps: int,
                   n_envs: int, k_per_env: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The random part of ``sample_windows``: (B, k) round indices in
    [0, min(r + 1, rounds)) and window-end steps in [0, T), on the
    generator's device."""
    r_i = torch.randint(0, min(r + 1, rounds), (n_envs, k_per_env), generator=generator)
    t_i = torch.randint(0, n_steps, (n_envs, k_per_env), generator=generator)
    return r_i, t_i


def gather_windows_at(frames: torch.Tensor, labels: torch.Tensor, dones: torch.Tensor,
                      r_i: torch.Tensor, t_i: torch.Tensor, frame_skip: int,
                      extras: tuple = ()):
    """Windows ending at (round r_i, step t_i) of each env row: frames
    (R, T, B, H, W) uint8, labels and dones (R, T, B); r_i, t_i (B, k).
    → env-major (obs (B·k, H, W, fs) float32 in [0, 1], labels (B·k,),
    weights (B·k,) float32), then each of ``extras`` (more (R, T, B) grids,
    e.g. CIL speeds and commands) at the same (round, step), flat.
    The frames divide by 255 (the JAX package's
    spelling here, which can differ in the last bit from the rollout's
    multiply by 1/255). The weight is 0 where t < fs − 1 (the window starts
    before the trajectory) or where one of the window's first fs − 1 frames
    is followed by a reset. A start before the trajectory is placed as
    ``lax.dynamic_slice`` places it, counted from the end and clamped to
    [0, T − fs], so such a window holds real frames at weight 0."""
    fs = frame_skip
    n_envs, k = r_i.shape
    n_steps = frames.shape[1]
    dev = frames.device
    r_i, t_i = r_i.to(dev), t_i.to(dev)
    start = t_i - (fs - 1)
    start = torch.clamp(torch.where(start < 0, start + n_steps, start), 0, n_steps - fs)
    steps = start[..., None] + torch.arange(fs, device=dev)                 # (B, k, fs)
    env = torch.arange(n_envs, device=dev)[:, None, None]
    win = frames[r_i[..., None], steps, env]                                # (B, k, fs, H, W)
    torn = dones[r_i[..., None], steps, env][..., :-1].any(-1)
    ok = (t_i >= fs - 1) & ~torn
    obs = win.permute(0, 1, 3, 4, 2).to(torch.float32) / 255.0
    y = labels[r_i, t_i, env[..., 0]]
    flat = n_envs * k
    ex = tuple(g[r_i, t_i, env[..., 0]].reshape(flat) for g in extras)
    return (obs.reshape((flat,) + tuple(obs.shape[2:])), y.reshape(flat),
            ok.to(torch.float32).reshape(flat)) + ex


def sample_windows(generator: torch.Generator, frames: torch.Tensor, labels: torch.Tensor,
                   dones: torch.Tensor, r: int, k_per_env: int, frame_skip: int,
                   extras: tuple = ()):
    """``B × k_per_env`` training windows from the buffer, stratified by env,
    rounds ≤ r eligible: ``gather_windows_at`` of ``window_indices``."""
    R, T, B = labels.shape
    r_i, t_i = window_indices(generator, r, R, T, B, k_per_env)
    return gather_windows_at(frames, labels, dones, r_i, t_i, frame_skip, extras)


def masked_cross_entropy(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Σ w·ce / max(Σ w, 1) in at least float32."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    ce = -F.log_softmax(logits, -1).gather(1, y.to(torch.int64)[:, None])[:, 0]
    w = w.to(ce.dtype)
    return (w * ce).sum() / torch.clamp(w.sum(), min=1.0)


def make_online_dagger(model_apply: Callable, params: SimParams, town: TownMap,
                       rcfg: RenderConfig, n_envs: int, n_steps: int, rounds: int,
                       train_steps: int, batch: int, frame_skip: int = 4,
                       beta: float = 0.0, mesh=None, cil: bool = False, goal_ids=None,
                       speed_weight: float = 0.1, device: str | torch.device = "cuda"):
    """Build ``run(state: TrainState, generator) -> (state, metrics)``.

    ``model_apply(module, obs) -> logits`` applies the state's model (e.g.
    ``PolicyCNN.__call__``). ``batch`` becomes ``batch // n_envs`` windows
    per env (at least one). metrics, per round (host numpy arrays):
    ``loss``, the mean masked CE over the round's train steps;
    ``agreement``, the share of rollout steps whose executed action equals
    the expert's (exactly 1.0 where β_r = 1); ``valid_frac``, the mean
    sample weight. The renderer takes ``rcfg`` as given apart from the fast
    grayscale path: unlike ``make_rollout`` it forces no 2 px LOD, so the
    default ``lod_px = -1`` renders with none. The rollout draws the reset
    states, the β coins and the windows from ``generator``; auto-resets
    draw from ``rollout_spawn_pool``.

    ``cil=True`` conditions the loop on commands: ``model_apply(module,
    obs, speed, command) -> (logits, pred_speed)`` (``BranchedCILPolicy``),
    the buffer also keeps each step's speed and navigation command, the
    policy drives on the live command, and the loss adds ``speed_weight``
    times the weighted MSE of the speed head (the ``cil_loss_fn`` recipe).
    ``goal_ids`` (B,) sets each env's goal once on a town with nav tables
    (goals survive auto-resets), so every round is goal-directed."""
    if mesh is not None:
        raise NotImplementedError(
            "online DAgger over a mesh is not ported yet (ROADMAP Queue 1 item 12)")
    dev = resolve_device(device)
    town = town.to(dev)
    rcfg = dataclasses.replace(rcfg, rgb=False, fast=True)
    render = make_renderer(params, town, rcfg, device=dev)
    pool = rollout_spawn_pool(params, town).to(dev)
    k_per_env = max(1, batch // n_envs)
    H, W = rcfg.height, rcfg.width

    def quantize(states):
        return torch.clamp(render(states)["gray"] * 255.0 + 0.5, 0, 255).to(torch.uint8)

    def policy_logits(model, obs, speed, command):
        if cil:
            return model_apply(model, obs, speed, command)[0]
        return model_apply(model, obs)

    @torch.no_grad()
    def rollout_round(model, states, framebuf, just_reset, generator, beta_r: float,
                      frames, labels, dones, speeds, commands):
        """β-mixed rollout writing its (T, B, ...) frames, labels and dones
        (and with ``cil`` speeds and commands) into the buffer's round
        slices → (carry, agreement share)."""
        agree = torch.zeros((), dtype=torch.int64, device=dev)
        for t in range(n_steps):
            gray_u8 = quantize(states)
            framebuf = update_framebuf(framebuf, gray_u8, just_reset)
            expert = autopilot_control(params, town, states)
            expert_action = continuous_to_discrete(
                expert.steer, expert.throttle, expert.brake).to(torch.int64)
            if cil:
                speeds[t] = states.ego_v
                commands[t] = navigation_command(params, town, states)
            if beta_r >= 1.0:       # a uniform draw is always below 1
                action = expert_action
            else:
                obs = framebuf.to(torch.float32) * (1.0 / 255.0)
                action = policy_logits(model, obs, states.ego_v,
                                       commands[t] if cil else None).argmax(-1)
                if beta_r > 0.0:
                    use_expert = (torch.rand(n_envs, generator=generator) < beta_r).to(dev)
                    action = torch.where(use_expert, expert_action, action)
            fresh = pick_fresh_packed(pool, params, states)
            states, info = step_env(params, town, states, control_from_discrete(action), fresh)
            just_reset = info["done"]
            frames[t], labels[t], dones[t] = gray_u8, expert_action, just_reset
            agree += (action == expert_action).sum()
        return (states, framebuf, just_reset), agree / (n_steps * n_envs)

    def train_on_buffer(state: TrainState, generator, frames, labels, dones, r: int,
                        speeds, commands):
        losses, vfracs = [], []
        for _ in range(train_steps):
            state.optimizer.zero_grad(set_to_none=True)
            if cil:
                obs, y, w, sp, cm = sample_windows(generator, frames, labels, dones, r,
                                                   k_per_env, frame_skip, (speeds, commands))
                logits, pred_speed = model_apply(state.model, obs, sp, cm)
                loss = masked_cross_entropy(logits, y, w)
                wf = w.to(pred_speed.dtype)
                loss = loss + speed_weight * (
                    (wf * (pred_speed - sp) ** 2).sum() / torch.clamp(wf.sum(), min=1.0))
            else:
                obs, y, w = sample_windows(generator, frames, labels, dones, r, k_per_env,
                                           frame_skip)
                loss = masked_cross_entropy(model_apply(state.model, obs), y, w)
            loss.backward()
            state.apply_gradients()
            losses.append(loss.detach())
            vfracs.append(w.mean())
        return torch.stack(losses).mean(), torch.stack(vfracs).mean()

    def run(state: TrainState, generator: torch.Generator):
        states = reset_env(params, town, generator, n_envs)
        if goal_ids is not None:
            states = states.replace(goal=torch.as_tensor(
                np.asarray(goal_ids), dtype=torch.int64).to(dev))
        with torch.no_grad():
            framebuf = quantize(states)[..., None].repeat(1, 1, 1, frame_skip)
        just_reset = torch.zeros(n_envs, dtype=torch.bool, device=dev)
        frames = torch.zeros((rounds, n_steps, n_envs, H, W), dtype=torch.uint8, device=dev)
        labels = torch.zeros((rounds, n_steps, n_envs), dtype=torch.int64, device=dev)
        dones = torch.zeros((rounds, n_steps, n_envs), dtype=torch.bool, device=dev)
        speeds = commands = None
        if cil:
            speeds = torch.zeros((rounds, n_steps, n_envs), dtype=torch.float32, device=dev)
            commands = torch.zeros((rounds, n_steps, n_envs), dtype=torch.int64, device=dev)
        per_round = []
        for r in range(rounds):
            beta_r = float(np.float32(beta) ** r)            # 0 ** 0 == 1
            (states, framebuf, just_reset), agree = rollout_round(
                state.model, states, framebuf, just_reset, generator, beta_r,
                frames[r], labels[r], dones[r],
                None if speeds is None else speeds[r],
                None if commands is None else commands[r])
            loss, vfrac = train_on_buffer(state, generator, frames, labels, dones, r,
                                          speeds, commands)
            per_round.append(torch.stack([loss.to(torch.float32),
                                          agree.to(torch.float32), vfrac]))
        host = torch.stack(per_round).cpu().numpy()
        return state, {"loss": host[:, 0], "agreement": host[:, 1], "valid_frac": host[:, 2]}

    return run

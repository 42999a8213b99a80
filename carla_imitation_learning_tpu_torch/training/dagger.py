"""The DAgger loops of the JAX package's ``experiments.py`` (``dagger``,
``dagger_online``, ``dagger_uncertain``) and the ensemble that the
uncertainty-gated loop drives with.

Each loop takes what the experiments' ``_sim_bits`` builds (``SimParams``,
``TownMap``, ``RenderConfig``), a ``torch.Generator`` in place of the
config's seed, and the experiments' own arguments with their defaults.
What they read from the imitation config is fixed to that config's values
(``EXPERIMENT_CFG``): a bf16 policy on 4-frame windows, batch 64
(an argument), Adam 1e-3 with the global-norm clip 0.5, and the rate ×0.1
at steps 20 and 30 (the experiments build their optimizer with one step
per epoch, so the ``LR_MILESTONES`` of 20 and 30 epochs fall at those
steps). The config's other keys are arguments here: collection noise
(``noise``), ``policy_family``, ``n_goals``, ``balanced`` sampling and the
expert-mix schedule (``beta`` of ``run_dagger_online``); the experiments
of the same names (``experiments.py``) read them from the config.

The ensemble keeps its K members' parameters stacked on a leading K axis:
one ``vmap``ped forward serves every member, and one Adam over the stacked
tensors equals K separate Adams (Adam is elementwise); the global-norm clip
is taken per member.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, stack_module_state, vmap

from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
from carla_imitation_learning_tpu_torch.device import resolve_device
from carla_imitation_learning_tpu_torch.models import (
    BranchedCILPolicy, ContinuousPolicyCNN, PolicyCNN,
)
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.planner import goal_setup
from carla_imitation_learning_tpu_torch.sim.town import TownMap
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import closed_loop as cl
from carla_imitation_learning_tpu_torch.training.losses import (
    bc_loss_fn, cil_loss_fn, continuous_bc_loss_fn,
)
from carla_imitation_learning_tpu_torch.training.online_dagger import make_online_dagger
from carla_imitation_learning_tpu_torch.training.steps import (
    ADAM_BETAS, ADAM_EPS, AdamConfig, create_train_state, flax_init_, make_optimizer,
    make_train_step,
)

# the imitation config's settings that the DAgger experiments read
EXPERIMENT_CFG = {"BATCH_SIZE": 64, "LEARNING_RATE": 1e-3, "LR_MILESTONES": [20, 30],
                  "LR_GAMMA": 0.1, "gradient_clip_val": 0.5}


def experiment_optimizer() -> AdamConfig:
    """The experiments' ``make_optimizer(cfg, 1)`` on ``EXPERIMENT_CFG``."""
    return make_optimizer(EXPERIMENT_CFG, 1)


class Ensemble:
    """K policies of one architecture with parameters stacked on a leading
    K axis, trained together by one Adam on a shared batch.

    ``members`` are modules of the same class and shape; their weights are
    copied into the stack (``torch.func.stack_module_state``) and the
    forward runs once for all of them (``vmap`` of ``functional_call``)."""

    def __init__(self, members: list[nn.Module], tx: AdamConfig,
                 device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        members = [m.to(dev) for m in members]
        self.k = len(members)
        self.params, self.buffers = stack_module_state(members)
        self.base = copy.deepcopy(members[0]).to("meta")
        self.tx = tx
        self.step = 0
        self.optimizer = torch.optim.Adam(list(self.params.values()), lr=tx.schedule(0),
                                          betas=ADAM_BETAS, eps=ADAM_EPS)

        def one(p, b, x):
            return functional_call(self.base, (p, b), (x,))

        self._forward = vmap(one, in_dims=(0, 0, None))

    def logits(self, obs: torch.Tensor) -> torch.Tensor:
        """(B, ...) → (K, B, n_actions): every member on the same input."""
        return self._forward(self.params, self.buffers, obs)

    def member(self, i: int) -> dict:
        """Member ``i``'s parameters as a state_dict (copies)."""
        return {k: v[i].detach().clone() for k, v in self.params.items()}

    def train_step(self, batch) -> dict:
        """One optimizer step of every member on the shared ``(x, y)``
        batch: each member's mean CE, its own gradients, the global-norm
        clip per member, then Adam. → {"loss": (K,), "accuracy": (K,)}."""
        x, y = batch
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.logits(x)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        ce = F.cross_entropy(logits.flatten(0, 1), y.to(torch.int64).repeat(self.k),
                             reduction="none").view(self.k, -1).mean(1)
        ce.sum().backward()
        params = list(self.params.values())
        if self.tx.clip > 0:
            clip_per_member_([p.grad for p in params], self.tx.clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.tx.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        acc = (logits.detach().argmax(-1) == y[None]).to(torch.float32).mean(1)
        return {"loss": ce.detach(), "accuracy": acc}


def clip_per_member_(grads: list, max_norm: float) -> None:
    """optax's global-norm clip of each member's gradients, in place: each
    (K, ...) gradient's slice i is scaled by member i's factor, the norm
    taken over member i's slices of all of them."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.flatten(1), dim=1) for g in grads]), dim=0)
    trigger = norm < max_norm
    one = torch.ones_like(norm)
    div = torch.where(trigger, one, norm)
    mul = torch.where(trigger, one, max_norm * one)
    for g in grads:
        shape = (-1,) + (1,) * (g.dim() - 1)
        g.div_(div.view(shape)).mul_(mul.view(shape))


def ensemble_policy_from(ensemble: Ensemble) -> Callable:
    """Majority vote of the members' argmaxes → ``policy_fn(obs) ->
    (action (B,), disagreement (B,))``, ties to the lowest action (as
    ``argmax`` breaks them); disagreement = max(1 − top count / K, 0)."""

    @torch.no_grad()
    def policy_fn(obs):
        logits = ensemble.logits(obs)                                      # (K, B, A)
        votes = logits.argmax(-1)
        counts = (votes[..., None] == torch.arange(logits.shape[-1], device=votes.device)).sum(0)
        action = counts.argmax(-1)
        top = counts.max(-1).values.to(torch.float32)
        return action, torch.clamp(1.0 - top / float(ensemble.k), min=0.0)

    return policy_fn


def _argmax_policy(model: nn.Module) -> Callable:
    @torch.no_grad()
    def policy_fn(obs):
        return model(obs).argmax(-1)

    return policy_fn


def _control_policy(model: nn.Module) -> Callable:
    @torch.no_grad()
    def policy_fn(obs):
        return model(obs)

    return policy_fn


def family_bits(policy_family: str, n_commands: int = 6, speed_weight: float = 0.1,
                steer_weight: float = 1.0, accel_weight: float = 0.5,
                dtype: torch.dtype = torch.bfloat16):
    """→ (model, loss_fn, policy_from(model) -> policy_fn, control space)
    of a policy family, as the JAX package's DAgger experiments build them:
    ``discrete`` (``PolicyCNN``, CE, argmax), ``continuous``
    (``ContinuousPolicyCNN``, weighted MSE, the controls as they come) or
    ``cil`` (``BranchedCILPolicy`` with ``n_commands`` branches, CE plus
    the speed head's MSE, ``as_policy_fn``), computing in ``dtype``."""
    if policy_family == "continuous":
        return (ContinuousPolicyCNN(dtype=dtype),
                continuous_bc_loss_fn(steer_weight, accel_weight), _control_policy,
                "continuous")
    if policy_family == "cil":
        return (BranchedCILPolicy(n_commands=n_commands, dtype=dtype),
                cil_loss_fn(speed_weight), BranchedCILPolicy.as_policy_fn, "discrete")
    if policy_family != "discrete":
        raise ValueError(f"unknown policy_family {policy_family!r}")
    return PolicyCNN(dtype=dtype), bc_loss_fn, _argmax_policy, "discrete"


def run_dagger(params: SimParams, town: TownMap, rcfg: RenderConfig,
               generator: torch.Generator, rounds: int = 3, n_envs: int = 16,
               n_steps: int = 200, epochs_per_round: int = 3, n_goals: int = 0,
               batch_size: int = EXPERIMENT_CFG["BATCH_SIZE"],
               noise: cl.NoiseConfig | None = None, policy_family: str = "discrete",
               n_commands: int = 6, speed_weight: float = 0.1, steer_weight: float = 1.0,
               accel_weight: float = 0.5, balanced: bool = False, goal_seed: int = 0,
               tx: AdamConfig | None = None, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    """The ``dagger`` experiment: round 0 collects with the expert (with
    ``noise``, the only noisy round), later rounds with the current policy
    (``dagger_iteration``); each round trains ``epochs_per_round`` epochs
    on ``FrameStore.concat`` of every round's store (``DeviceDataset``,
    shuffled, seed = round, ``balanced`` by action) and evaluates the
    policy at ``min(n_envs, 32)`` envs × 100 steps. ``policy_family``
    (``family_bits``) picks the model: a continuous policy drives with
    continuous control and trains on the expert's ``controls``, a CIL
    policy on the commands; the loss weights are ``cil_loss_fn``'s and
    ``continuous_bc_loss_fn``'s. With ``n_goals`` > 0 every round is
    goal-directed (``goal_setup`` on the town, which needs turn fans, from
    ``goal_seed``), and the final policy is also scored by
    ``evaluate_routes`` on the same env → goal assignment. ``tx`` (default
    ``experiment_optimizer()``) and ``dtype`` set the optimizer and the
    compute dtype. → {"rounds": [metrics + round, train_loss,
    dataset_frames][, "routes": ...]}."""
    dev = resolve_device(device)
    goal_ids = None
    if n_goals > 0:
        town, _, goal_ids = goal_setup(town, n_goals, n_envs, goal_seed)
    model, loss_fn, policy_from, space = family_bits(policy_family, n_commands, speed_weight,
                                                     steer_weight, accel_weight, dtype)
    state = create_train_state(model, tx or experiment_optimizer(), generator=generator,
                               device=dev)
    step = make_train_step(loss_fn)
    stores, history = [], []
    for rnd in range(rounds):
        if rnd == 0:
            store, _, _ = cl.collect_dataset(params, town, rcfg, generator, n_envs, n_steps,
                                             noise=noise, goal_ids=goal_ids, device=dev)
        else:
            store, _, _ = cl.dagger_iteration(params, town, rcfg, policy_from(state.model),
                                              generator, n_envs, n_steps,
                                              control_space=space, goal_ids=goal_ids,
                                              device=dev)
        stores.append(store)
        agg = FrameStore.concat(stores)
        ds = DeviceDataset(agg, batch_size, shuffle=True, seed=rnd,
                           cil=policy_family == "cil", balanced=balanced,
                           continuous_labels=agg.controls if space == "continuous" else None,
                           device=dev)
        last = {}
        for _ in range(epochs_per_round):
            for batch in ds:
                state, last = step(state, batch)
        m = cl.evaluate_policy(params, town, rcfg, policy_from(state.model), generator,
                               n_envs=min(n_envs, 32), n_steps=100, control_space=space,
                               device=dev)
        m["round"] = rnd
        m["train_loss"] = float(last["loss"]) if last else float("nan")
        m["dataset_frames"] = len(agg)
        history.append(m)
    out = {"rounds": history}
    if n_goals > 0:
        out["routes"] = cl.evaluate_routes(params, town, rcfg, policy_from(state.model),
                                           generator, n_envs=n_envs, n_steps=n_steps,
                                           control_space=space, goal_ids=goal_ids,
                                           device=dev)
    return out


def run_dagger_online(params: SimParams, town: TownMap, rcfg: RenderConfig,
                      generator: torch.Generator, rounds: int = 3, n_envs: int = 16,
                      n_steps: int = 200, train_steps_per_round: int = 200,
                      eval_steps: int = 100, n_goals: int = 0,
                      batch_size: int = EXPERIMENT_CFG["BATCH_SIZE"], beta: float = 0.0,
                      policy_family: str = "discrete", n_commands: int = 6,
                      speed_weight: float = 0.1, goal_seed: int = 0,
                      tx: AdamConfig | None = None, dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device = "cuda") -> dict:
    """The ``dagger_online`` experiment: ``make_online_dagger`` over a fresh
    policy with the expert-mix schedule β_r = ``beta``**r (the config's
    ``beta``, default 0.0), then ``evaluate_policy`` of the result at
    ``min(n_envs, 32)`` envs × ``eval_steps``. ``policy_family="cil"``
    runs the loop on commands (``BranchedCILPolicy``); any other family is
    the discrete ``PolicyCNN``, as in the JAX package. With ``n_goals`` > 0
    every round is goal-directed and the final policy is also scored by
    ``evaluate_routes`` on the same goals. ``tx`` and ``dtype`` as in
    ``run_dagger``."""
    dev = resolve_device(device)
    goal_ids = None
    if n_goals > 0:
        town, _, goal_ids = goal_setup(town, n_goals, n_envs, goal_seed)
    cil = policy_family == "cil"
    model = (BranchedCILPolicy(n_commands=n_commands, dtype=dtype) if cil
             else PolicyCNN(dtype=dtype))
    state = create_train_state(model, tx or experiment_optimizer(), generator=generator,
                               device=dev)
    run = make_online_dagger(type(model).__call__, params, town, rcfg, n_envs=n_envs,
                             n_steps=n_steps, rounds=rounds, train_steps=train_steps_per_round,
                             batch=batch_size, beta=beta, cil=cil, goal_ids=goal_ids,
                             speed_weight=speed_weight, device=dev)
    state, metrics = run(state, generator)
    policy_fn = state.model.as_policy_fn() if cil else _argmax_policy(state.model)
    final = cl.evaluate_policy(params, town, rcfg, policy_fn, generator,
                               n_envs=min(n_envs, 32), n_steps=eval_steps, device=dev)
    out = {"loss_per_round": [float(x) for x in metrics["loss"]],
           "agreement_per_round": [float(x) for x in metrics["agreement"]],
           "valid_frac_per_round": [float(x) for x in metrics["valid_frac"]],
           "final_eval": final}
    if n_goals > 0:
        out["routes"] = cl.evaluate_routes(params, town, rcfg, policy_fn, generator,
                                           n_envs=n_envs, n_steps=n_steps,
                                           goal_ids=goal_ids, device=dev)
    return out


def run_dagger_uncertain(params: SimParams, town: TownMap, rcfg: RenderConfig,
                         generator: torch.Generator, rounds: int = 3, n_envs: int = 16,
                         n_steps: int = 200, epochs_per_round: int = 3, ensemble: int = 4,
                         tau: float = 0.25, batch_size: int = EXPERIMENT_CFG["BATCH_SIZE"],
                         device: str | torch.device = "cuda") -> dict:
    """The ``dagger_uncertain`` experiment: a K-member ensemble drives by
    majority vote and the expert labels. Round 0 is an expert collection
    that trains on every window; later rounds keep only the windows whose
    labelled frame the ensemble disagreed on (disagreement ≥ ``tau``), or
    the whole round when none did, through ``DeviceDataset(sample_mask=)``.
    The members train together, one step each per shared batch."""
    dev = resolve_device(device)
    members = [flax_init_(PolicyCNN(), generator) for _ in range(ensemble)]
    ens = Ensemble(members, experiment_optimizer(), device=dev)
    stores, masks, history = [], [], []
    for rnd in range(rounds):
        if rnd == 0:
            store, _, _ = cl.collect_dataset(params, town, rcfg, generator, n_envs, n_steps,
                                             device=dev)
            mask = np.ones(len(store), bool)
            unc_mean = float("nan")
        else:
            store, _, traj = cl.dagger_iteration(params, town, rcfg, ensemble_policy_from(ens),
                                                 generator, n_envs, n_steps, device=dev)
            unc = traj["policy_extra"].T.reshape(-1).cpu().numpy()    # env-major
            mask = unc >= float(tau)
            unc_mean = float(unc.mean())
            if not mask.any():
                mask[:] = True
        stores.append(store)
        masks.append(mask)
        agg = FrameStore.concat(stores)
        ds = DeviceDataset(agg, batch_size, shuffle=True, seed=rnd,
                           sample_mask=np.concatenate(masks), device=dev)
        last = {}
        for _ in range(epochs_per_round):
            for batch in ds:
                last = ens.train_step(batch)
        m = cl.evaluate_policy(params, town, rcfg, ensemble_policy_from(ens), generator,
                               n_envs=min(n_envs, 32), n_steps=100, device=dev)
        m.update(round=rnd, ensemble=ensemble, tau=float(tau), mean_disagreement=unc_mean,
                 train_loss=float(last["loss"].mean()) if last else float("nan"),
                 dataset_frames=len(agg), trained_windows=ds.n_samples)
        history.append(m)
    return {"rounds": history}

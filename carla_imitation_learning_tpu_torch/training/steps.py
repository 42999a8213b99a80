"""Train state, optimizer and train / eval steps (the JAX package's
``training/steps.py``).

The optimizer is the JAX package's optax chain written out: optional
clipping by global norm (``where(norm < max, g, g / norm * max)`` over all
gradients, as optax computes it), then Adam (b1 0.9, b2 0.999, eps 1e-8)
with a piecewise-constant learning rate on the optimizer's step count
(×gamma once ``count >= milestone · steps_per_epoch``, count from 0).
Adam itself, the convolutions and the matrix products are PyTorch's
library calls. Nothing here reads a device value on the host: a step's
metrics stay device tensors, and the fused epoch stacks them so that its
caller syncs once per epoch.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from carla_imitation_learning_tpu_torch.device import resolve_device

# std of a standard normal truncated to [-2, 2]: flax's lecun_normal divides by it
_TRUNC_STD = 0.87962566103423978
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8   # optax.adam's defaults


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    """What ``make_optimizer`` returns: the learning-rate schedule (a
    function of the step count) and the global-norm clip (0 = none)."""

    schedule: Callable[[int], float]
    clip: float = 0.0


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return copy.deepcopy(obj)


@dataclasses.dataclass
class TrainState:
    """Model, optimizer and step count, updated in place by the steps.

    ``ema`` (optional) is a Polyak shadow of the model, updated after every
    optimizer step as ``e·d + p·(1 − d)``; evaluation then runs on it
    (``eval_params``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: AdamConfig
    step: int = 0
    ema: nn.Module | None = None
    ema_decay: float = 0.0

    def apply_gradients(self) -> None:
        """One optimizer step from the gradients in the parameters' ``.grad``."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        if self.tx.clip > 0:
            clip_by_global_norm_([p.grad for p in params], self.tx.clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.tx.schedule(self.step)
        self.optimizer.step()
        if self.ema is not None:
            d = self.ema_decay
            shadow = list(self.ema.parameters())
            torch._foreach_mul_(shadow, d)
            torch._foreach_add_(shadow, torch._foreach_mul(
                [p.detach() for p in self.model.parameters()], 1.0 - d))
        self.step += 1

    def snapshot(self) -> dict:
        """A copy of everything a step changes, owning its own tensors."""
        return {"model": _clone(self.model.state_dict()),
                "optimizer": _clone(self.optimizer.state_dict()),
                "step": self.step,
                "ema": None if self.ema is None else _clone(self.ema.state_dict())}

    def payload(self) -> dict:
        """The checkpoint payload: ``{"params", "opt_state", "step"[,
        "ema_params"]}`` (state_dicts and the step count)."""
        out = {"params": self.model.state_dict(),
               "opt_state": self.optimizer.state_dict(), "step": self.step}
        if self.ema is not None:
            out["ema_params"] = self.ema.state_dict()
        return out

    def load_payload(self, payload: dict) -> None:
        """Continue from a checkpoint ``payload`` (``payload()``'s form)."""
        self.model.load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.step = int(payload["step"])
        if self.ema is not None:
            self.ema.load_state_dict(payload["ema_params"])

    def restore(self, snap: dict) -> None:
        """Set the state back to ``snap`` (which stays untouched)."""
        self.model.load_state_dict(snap["model"])
        self.optimizer.load_state_dict(_clone(snap["optimizer"]))
        self.step = snap["step"]
        if self.ema is not None:
            self.ema.load_state_dict(snap["ema"])


def clip_by_global_norm_(grads: list, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: every gradient becomes
    ``where(norm < max_norm, g, g / norm * max_norm)`` with ``norm`` the
    norm of all of them together. Dividing by 1 and multiplying by 1 are
    exact, so the untriggered branch leaves ``g`` as it was."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    trigger = norm < max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(trigger, one, norm))
    torch._foreach_mul_(grads, torch.where(trigger, one, max_norm * one))


def eval_params(state: TrainState) -> nn.Module:
    """The module evaluation runs on: the EMA shadow when tracked, else the model."""
    return state.ema if state.ema is not None else state.model


def make_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Piecewise-constant ×``LR_GAMMA`` at ``LR_MILESTONES`` epochs: the
    rate at step count ``count`` is scaled once for each milestone with
    ``count >= milestone · steps_per_epoch`` (optax's
    ``piecewise_constant_schedule``)."""
    lr = float(cfg.get("LEARNING_RATE", 1e-3))
    milestones = cfg.get("LR_MILESTONES", None)
    if not milestones:
        return lambda count: lr
    gamma = float(cfg.get("LR_GAMMA", 0.1))
    boundaries = {int(e) * steps_per_epoch: gamma for e in milestones}

    def schedule(count: int) -> float:
        value = lr
        for threshold, scale in boundaries.items():
            if count >= threshold:
                value *= scale
        return value

    return schedule


def make_optimizer(cfg, steps_per_epoch: int = 1) -> AdamConfig:
    """Adam with the schedule of ``make_lr_schedule`` and, when the config
    sets ``trainer.gradient_clip_val`` (or ``gradient_clip_val``), clipping
    by global norm."""
    clip = float(cfg.get_dotted("trainer.gradient_clip_val", 0.0) or 0.0) \
        if hasattr(cfg, "get_dotted") else float(cfg.get("gradient_clip_val", 0.0))
    return AdamConfig(schedule=make_lr_schedule(cfg, steps_per_epoch), clip=clip)


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``model``'s weights as flax's ``nn.Conv`` / ``nn.Dense`` /
    ``nn.ConvTranspose`` defaults do: ``lecun_normal`` kernels (a normal
    truncated to ±2 std, scaled to std sqrt(1 / fan_in)) and zero biases,
    in module order, from
    ``generator`` (a CPU generator; the draws are copied to the model's
    device). A module may also list raw parameters that flax draws alike:
    ``flax_kernels`` (fan-in over all but the last axis, as flax's
    variance scaling counts a stacked kernel) and ``flax_biases`` (zeros)."""

    def draw_(w: torch.Tensor, fan_in: int) -> None:
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        draw = torch.empty(w.shape, dtype=w.dtype)
        torch.nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std,
                                    generator=generator)
        with torch.no_grad():
            w.copy_(draw)

    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            w = module.weight
            # a transposed conv's weight is (in, out, kh, kw); flax counts
            # its (kh, kw, in, out) kernel's fan-in as kh · kw · in too
            fan_in = w.shape[0] if isinstance(module, nn.ConvTranspose2d) else w.shape[1]
            draw_(w, fan_in * math.prod(w.shape[2:]))
            if module.bias is not None:
                with torch.no_grad():
                    module.bias.zero_()
        for name in getattr(module, "flax_kernels", ()):
            w = getattr(module, name)
            draw_(w, math.prod(w.shape[:-1]))
        for name in getattr(module, "flax_biases", ()):
            with torch.no_grad():
                getattr(module, name).zero_()
    return model


def create_train_state(model: nn.Module, tx: AdamConfig,
                       generator: torch.Generator | None = None,
                       ema_decay: float = 0.0,
                       device: str | torch.device = "cuda") -> TrainState:
    """Move ``model`` to ``device`` and build its optimizer. With a
    ``generator`` the weights are drawn anew (``flax_init_``), so a policy
    trained from scratch starts from the JAX package's distribution;
    without one they are kept (e.g. weights carried across by
    ``convert``). ``ema_decay`` > 0 seeds an EMA shadow of the weights."""
    dev = resolve_device(device)
    if generator is not None:
        flax_init_(model, generator)
    model.to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=tx.schedule(0),
                                 betas=ADAM_BETAS, eps=ADAM_EPS)
    ema = None
    if ema_decay > 0.0:
        ema = copy.deepcopy(model)
        ema.requires_grad_(False)
    return TrainState(model=model, optimizer=optimizer, tx=tx, ema=ema,
                      ema_decay=float(ema_decay))


def _train_one(state: TrainState, loss_fn, batch, generator):
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state.model, batch, generator)
    loss.backward()
    state.apply_gradients()
    return metrics


def make_train_step(loss_fn):
    """``step(state, batch, generator=None) -> (state, metrics)``: forward,
    backward and optimizer update, in place."""

    def step(state: TrainState, batch, generator: torch.Generator | None = None):
        return state, _train_one(state, loss_fn, batch, generator)

    return step


def make_eval_step(loss_fn):
    """``step(state, batch) -> metrics`` on ``eval_params(state)``."""

    @torch.no_grad()
    def step(state: TrainState, batch):
        return loss_fn(eval_params(state), batch, None)[1]

    return step


@torch.no_grad()
def predict_step(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return model(x).argmax(-1)


def _stack(metrics: list) -> dict:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_fused_epoch(loss_fn, pure_batch: Callable):
    """Whole-epoch runner over the rows of an (n_batches, B) device matrix of
    sample indices: ``epoch(state, order, generator=None) -> (state,
    generator, stacked metrics (n_batches,))``. The order is uploaded once
    by the caller and no step reads a device value on the host."""

    def epoch(state: TrainState, order: torch.Tensor,
              generator: torch.Generator | None = None):
        metrics = [_train_one(state, loss_fn, pure_batch(idx), generator) for idx in order]
        return state, generator, _stack(metrics)

    return epoch


def make_fused_eval(loss_fn, pure_batch: Callable):
    """Eval counterpart of ``make_fused_epoch``: ``run(state, order) ->
    stacked metrics``."""
    eval_step = make_eval_step(loss_fn)

    def run(state: TrainState, order: torch.Tensor):
        return _stack([eval_step(state, pure_batch(idx)) for idx in order])

    return run

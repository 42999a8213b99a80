"""Epoch-based fit loop (the JAX package's ``training/loop.py``).

- sanity validation steps before training;
- per-epoch means of the train / val metrics as history rows;
- ``limit_{train,val}_batches`` (a fraction below 1.0, or a count);
- the fused path when the train loader has ``pure_batch``: the epoch's
  order goes to the device once as an (n_batches, B) matrix and its metrics
  come back in one copy, so the host syncs once per epoch;
- on a non-finite epoch train loss, a rollback to a snapshot of the last
  good state, checked once per epoch;
- the validation split's partial last batch through one eval step.

A logger (``add_scalars``, ``add_scalars_flat``) and a checkpoint manager
(``save``, ``best``) are called when passed. ``trainer.profiler=trace``
records a ``torch.profiler`` trace (``utils.profiling.trace_profiler``)
of the epochs, from after the sanity validation to the end of the last
epoch as the JAX package's does, under ``trainer.trace_dir`` (default
``<log_dir>/<run name>/trace``).

Data parallel: a loader with a ``sharding`` (``parallel.mesh.batch_sharding``)
feeds each rank its rows, and its state must come from
``parallel.mesh.shard_train_state``. The steps' metrics are global means,
so the history, the NaN rollback and the best checkpoint come out the same
on every rank. Only rank 0 is handed a logger, callbacks and a writing
checkpoint manager (``experiments._trainer_bits``); every rank waits at the
end of ``fit`` until rank 0's checkpoints are on disk.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.device import resolve_device
from carla_imitation_learning_tpu_torch.training.steps import (
    TrainState, make_eval_step, make_fused_epoch, make_fused_eval, make_train_step,
)
from carla_imitation_learning_tpu_torch.utils.profiling import (
    SimpleProfiler, StepTimer, trace_profiler,
)


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: list[dict]
    best_metric: float | None
    best_path: str | None
    throughput: dict


def _limit(n_batches: int, limit) -> int:
    if limit is None:
        return n_batches
    if isinstance(limit, float):
        return max(1, int(n_batches * limit)) if limit < 1.0 else n_batches
    return min(n_batches, int(limit))


def _to_host(stacked: dict) -> dict:
    """{name: (n,) device tensor} → {name: float32 numpy array}, one copy."""
    keys = list(stacked)
    host = torch.stack([stacked[k].to(torch.float32) for k in keys]).cpu().numpy()
    return dict(zip(keys, host))


def _mean_metrics(metric_list: list[dict]) -> dict:
    if not metric_list:
        return {}
    host = _to_host({k: torch.stack([m[k] for m in metric_list]) for k in metric_list[0]})
    return {k: float(np.mean(v)) for k, v in host.items()}


def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None or t.device.index == dev.index)


class Trainer:
    """Fits a ``TrainState`` on ``device`` (default the card; without one the
    constructor raises). ``fit`` refuses a state whose model lives
    elsewhere."""

    def __init__(
        self,
        cfg,
        logger=None,
        callbacks: Sequence = (),
        checkpoint_manager=None,
        name: str = "run",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        tcfg = cfg.get("trainer", {})
        self.max_epochs = int(tcfg.get("max_epochs", cfg.get("NUM_EPOCHS", 1)))
        self.num_sanity_val_steps = int(tcfg.get("num_sanity_val_steps", 0))
        self.limit_train_batches = tcfg.get("limit_train_batches", 1.0)
        self.limit_val_batches = tcfg.get("limit_val_batches", 1.0)
        self.profiler = SimpleProfiler() if tcfg.get("profiler") == "simple" else None
        self.trace_dir = None
        if tcfg.get("profiler") == "trace":
            self.trace_dir = str(tcfg.get("trace_dir") or "") or None
            if self.trace_dir is None and cfg.get("log_dir"):
                self.trace_dir = str(Path(cfg["log_dir"]) / name / "trace")
            if self.trace_dir is None:
                raise ValueError("trainer.profiler=trace needs trainer.trace_dir or log_dir")
        # on a non-finite train loss, restore the last good state
        self.restore_on_nan = bool(tcfg.get("restore_on_nan", True))
        self.nan_events = 0
        self.logger = logger
        self.callbacks = list(callbacks)
        self.ckpt = checkpoint_manager
        self.name = name

    def _callback(self, hook: str, **kw) -> None:
        for cb in self.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(trainer=self, **kw)

    def _check_device(self, state: TrainState) -> None:
        p = next(state.model.parameters())
        if not _on_device(p, self.device):
            raise ValueError(f"the model lives on {p.device}, the trainer on {self.device}")

    def fit(
        self,
        state: TrainState,
        loss_fn: Callable,
        loaders: dict,
        generator: torch.Generator | None = None,
        max_epochs: int | None = None,
    ) -> FitResult:
        self._check_device(state)
        train_loader = loaders["train_dataloader"]
        val_loader = loaders.get("val_dataloader")
        train_sh = getattr(train_loader, "sharding", None)
        val_sh = getattr(val_loader, "sharding", None)
        if train_sh is not None and state.mesh is None:
            raise ValueError("a sharded train loader needs a state from "
                             "parallel.mesh.shard_train_state")
        train_step = make_train_step(loss_fn)
        eval_step = make_eval_step(loss_fn, None if val_sh is None else val_sh.mesh)
        fused_epoch = fused_eval = None
        if self.profiler is None and hasattr(train_loader, "pure_batch"):
            fused_epoch = make_fused_epoch(loss_fn, train_loader.pure_batch, train_sh)
            if val_loader is not None and hasattr(val_loader, "pure_batch"):
                fused_eval = make_fused_eval(loss_fn, val_loader.pure_batch, val_sh)
        max_epochs = max_epochs or self.max_epochs
        history: list[dict] = []
        timer = StepTimer(items_per_step=getattr(train_loader, "batch_size", 0))
        self._callback("on_fit_start", state=state)

        if val_loader is not None and self.num_sanity_val_steps:
            for i, batch in enumerate(val_loader):
                if i >= self.num_sanity_val_steps:
                    break
                eval_step(state, batch)

        with trace_profiler(self.trace_dir, enabled=self.trace_dir is not None):
            t_start = time.perf_counter()
            last_good = state.snapshot() if self.restore_on_nan else None
            for epoch in range(max_epochs):
                nb = _limit(len(train_loader), self.limit_train_batches)
                if fused_epoch is not None:
                    bsz = train_loader.batch_size
                    order = train_loader.epoch_indices()[:nb * bsz].astype(np.int64)
                    order_dev = torch.from_numpy(order.reshape(nb, bsz)).to(self.device)
                    state, generator, stacked = fused_epoch(state, order_dev, generator)
                    train_mean = {k: float(np.mean(v)) for k, v in _to_host(stacked).items()}
                    timer.tick(nb)
                else:
                    train_metrics: list[dict] = []
                    for i, batch in enumerate(train_loader):
                        if i >= nb:
                            break
                        if self.profiler:
                            with self.profiler.phase("train_step"):
                                state, metrics = train_step(state, batch, generator)
                        else:
                            state, metrics = train_step(state, batch, generator)
                        train_metrics.append(metrics)
                        timer.tick()
                    train_mean = _mean_metrics(train_metrics)
                epoch_row = {f"train_{k}": v for k, v in train_mean.items()}

                if self.restore_on_nan and not math.isfinite(epoch_row.get("train_loss", 0.0)):
                    self.nan_events += 1
                    state.restore(last_good)
                    epoch_row["nan_rollback"] = 1.0
                elif self.restore_on_nan:
                    last_good = state.snapshot()

                if val_loader is not None:
                    epoch_row.update(self._validate(state, val_loader, eval_step, fused_eval))

                epoch_row["epoch"] = epoch
                history.append(epoch_row)
                if self.logger is not None:
                    self.logger.add_scalars(
                        "losses", {k: v for k, v in epoch_row.items() if k.endswith("loss")},
                        step=epoch)
                    self.logger.add_scalars_flat(
                        {k: v for k, v in epoch_row.items() if k != "epoch"}, step=epoch)
                if self.ckpt is not None:
                    self.ckpt.save(epoch, state.payload(), epoch_row)
                self._callback("on_epoch_end", state=state, epoch=epoch, metrics=epoch_row,
                               loaders=loaders)

        if state.mesh is not None:
            state.mesh.barrier()   # rank 0's checkpoints are written
        elapsed = time.perf_counter() - t_start
        throughput = {
            "steps_per_sec": timer.steps / max(elapsed, 1e-9),
            "images_per_sec": timer.steps * timer.items_per_step / max(elapsed, 1e-9),
            "wall_s": elapsed,
        }
        self._callback("on_fit_end", state=state, history=history)
        if self.profiler:
            print(self.profiler.summary())
        best = self.ckpt.best if self.ckpt is not None else None
        return FitResult(state=state, history=history,
                         best_metric=(best or {}).get("metric"),
                         best_path=(best or {}).get("path"), throughput=throughput)

    def _validate(self, state, val_loader, eval_step, fused_eval) -> dict:
        nvb = _limit(len(val_loader), self.limit_val_batches)
        vb = getattr(val_loader, "batch_size", 0)
        n_full = (min(nvb * vb, getattr(val_loader, "n_samples", 0)) // vb) if vb else 0
        if fused_eval is not None and n_full >= 1:
            order = val_loader.epoch_indices()
            head = order[:n_full * vb].astype(np.int64).reshape(n_full, vb)
            vals = {k: list(v) for k, v in _to_host(
                fused_eval(state, torch.from_numpy(head).to(self.device))).items()}
            # the partial final batch (drop_last=False) through one step
            rem = val_loader.epoch_indices()[n_full * vb:nvb * vb]
            if len(rem):
                tail = _to_host({k: v[None] for k, v in eval_step(
                    state, val_loader.make_batch(rem)).items()})
                for k in vals:
                    vals[k].append(tail[k][0])
            return {f"val_{k}": float(np.mean(v)) for k, v in vals.items()}
        val_metrics: list[dict] = []
        for i, batch in enumerate(val_loader):
            if i >= nvb:
                break
            if self.profiler:
                with self.profiler.phase("val_step"):
                    val_metrics.append(eval_step(state, batch))
            else:
                val_metrics.append(eval_step(state, batch))
        return {f"val_{k}": v for k, v in _mean_metrics(val_metrics).items()}

    def test(self, state: TrainState, loss_fn: Callable, loaders: dict) -> dict:
        self._check_device(state)
        sh = getattr(loaders["test_dataloader"], "sharding", None)
        eval_step = make_eval_step(loss_fn, None if sh is None else sh.mesh)
        metrics = [eval_step(state, b) for b in loaders["test_dataloader"]]
        return {f"test_{k}": v for k, v in _mean_metrics(metrics).items()}

"""The callbacks the experiments attach to every fit (the JAX package's
``callbacks/callbacks.py``, its ``Callback``, ``SaveBestMetricScores``,
``SaveMetricsHeatmap`` and ``SaveConfusionMatrix``).

The per-class callbacks compute validation predictions at fit end when the
trainer passes ``loaders``, write ``per_class_metrics.json`` /
``confusion_matrix.npy`` to ``out_dir`` and log a table to wandb when a run
is live. The ``Trainer`` calls ``on_fit_end`` without ``loaders``, as the
JAX package's does, so inside a fit they return at once.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from carla_imitation_learning_tpu_torch.data.stats import (
    confusion_matrix, per_class_prf, predictions_and_labels,
)


class Callback:
    def on_fit_start(self, trainer, state, **kw):
        pass

    def on_epoch_end(self, trainer, state, epoch, metrics, loaders, **kw):
        pass

    def on_fit_end(self, trainer, state, history, **kw):
        pass


def _wandb_run():
    try:
        import wandb
    except ImportError:
        return None
    return wandb.run


class _ValPredictionCallback(Callback):
    """Validation-split predictions of the state's model at fit end."""

    def __init__(self, n_classes: int = 9, head: int | None = None,
                 out_dir: str | None = None):
        self.n_classes = n_classes
        self.head = head
        self.out_dir = Path(out_dir) if out_dir else None

    def _preds(self, state, loaders):
        return predictions_and_labels(state.model, loaders["val_dataloader"], self.head)


class SaveMetricsHeatmap(_ValPredictionCallback):
    """Per-class precision / recall / f1 table."""

    def on_fit_end(self, trainer, state, history, loaders=None, **kw):
        if loaders is None:
            return
        preds, labels = self._preds(state, loaders)
        p, r, f1 = per_class_prf(labels, preds, self.n_classes)
        table = {"precision": p.tolist(), "recall": r.tolist(), "f1": f1.tolist()}
        if self.out_dir:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            (self.out_dir / "per_class_metrics.json").write_text(json.dumps(table, indent=1))
        run = _wandb_run()
        if run is not None:
            import wandb

            run.log({"f1_p_r_heatmap": wandb.Table(
                columns=["class", "precision", "recall", "f1"],
                data=[[i, p[i], r[i], f1[i]] for i in range(self.n_classes)])})
        self.last = table


class SaveConfusionMatrix(_ValPredictionCallback):
    """Confusion matrix of the validation split."""

    def on_fit_end(self, trainer, state, history, loaders=None, **kw):
        if loaders is None:
            return
        preds, labels = self._preds(state, loaders)
        cm = confusion_matrix(labels, preds, self.n_classes)
        if self.out_dir:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            np.save(self.out_dir / "confusion_matrix.npy", cm)
        run = _wandb_run()
        if run is not None:
            import wandb

            run.log({"confusion_matrix": wandb.Table(
                columns=[str(i) for i in range(self.n_classes)], data=cm.tolist())})
        self.last = cm


class SaveBestMetricScores(Callback):
    """Best train / val loss and accuracy so far, logged every epoch."""

    def __init__(self):
        self.best: dict[str, float] = {}

    def on_epoch_end(self, trainer, state, epoch, metrics, loaders, **kw):
        for key, mode in (("train_loss", min), ("val_loss", min),
                          ("train_accuracy", max), ("val_accuracy", max)):
            if key in metrics:
                cur = self.best.get(f"best_{key}")
                self.best[f"best_{key}"] = metrics[key] if cur is None else mode(cur, metrics[key])
        if trainer.logger is not None and self.best:
            trainer.logger.add_scalars_flat(dict(self.best), step=epoch)

"""Training callbacks (the JAX package's ``callbacks/callbacks.py``): the
ones the experiments attach to every fit (``SaveBestMetricScores``,
``SaveMetricsHeatmap``, ``SaveConfusionMatrix``) and the reference's others
(``ExampleCallback``, ``UnfreezeModelCallback``, ``SaveCodeSnapshot``,
``UploadCheckpointsToWandb``).

The per-class callbacks compute validation predictions at fit end when the
trainer passes ``loaders``, write ``per_class_metrics.json`` /
``confusion_matrix.npy`` to ``out_dir`` and log a table to wandb when a run
is live. The ``Trainer`` calls ``on_fit_end`` without ``loaders``, as the
JAX package's does, so inside a fit they return at once.
"""

from __future__ import annotations

import json
import zipfile
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


class ExampleCallback(Callback):
    def __init__(self):
        print("Callback initialized.")

    def on_fit_start(self, trainer, state, **kw):
        print("Starting to train!")

    def on_fit_end(self, trainer, state, history, **kw):
        print("Training is done.")


class UnfreezeModelCallback(Callback):
    """``frozen`` is True until ``wait_epochs`` epochs have ended (the
    reference unfreezes ``requires_grad`` then); a loss or an optimizer that
    freezes parameters reads it through ``trainer.callbacks``."""

    def __init__(self, wait_epochs: int = 5):
        self.wait_epochs = wait_epochs
        self.frozen = True

    def on_epoch_end(self, trainer, state, epoch, metrics, loaders, **kw):
        if epoch + 1 >= self.wait_epochs:
            self.frozen = False


class SaveCodeSnapshot(Callback):
    """Zip the package's Python sources (this package's by default, or
    ``code_dir``'s) to ``out_dir/code_snapshot.zip`` at fit start, paths
    relative to the package's parent; a live wandb run also logs them."""

    def __init__(self, out_dir: str, code_dir: str | None = None):
        self.out_dir = Path(out_dir)
        self.code_dir = Path(code_dir) if code_dir else Path(__file__).resolve().parents[1]

    def on_fit_start(self, trainer, state, **kw):
        self.out_dir.mkdir(parents=True, exist_ok=True)
        out = self.out_dir / "code_snapshot.zip"
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
            for p in sorted(self.code_dir.rglob("*.py")):
                z.write(p, p.relative_to(self.code_dir.parent))
        run = _wandb_run()
        if run is not None:
            run.log_code(str(self.code_dir))


class UploadCheckpointsToWandb(Callback):
    """At fit end, ``ckpt_dir`` as a wandb artifact of a live run; without
    one it does nothing (no network)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = Path(ckpt_dir)

    def on_fit_end(self, trainer, state, history, **kw):
        run = _wandb_run()
        if run is None:
            return
        import wandb

        art = wandb.Artifact("experiment-ckpts", type="checkpoints")
        if self.ckpt_dir.exists():
            art.add_dir(str(self.ckpt_dir))
        run.log_artifact(art)


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

"""Evaluation statistics (the JAX package's ``data/stats.py``).

- ``predictions_and_labels`` / ``calculate_accuracy``: argmax predictions
  and accuracy of a model over a dataset split;
- ``save_predictions``: the ``predWlabels.npy`` dump;
- ``action_histogram`` and ``sample_output_plot``: label and prediction
  distributions (the plot needs matplotlib, imported when called);
- ``confusion_matrix`` / ``per_class_prf``: the metric math of the
  per-class callbacks, in numpy.

A model here is a ``torch.nn.Module`` mapping a batch's ``x`` to logits.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def predictions_and_labels(model, loader, head: int | None = None,
                           verbose: bool = False):
    """→ (predicted (N,), labels (N,)) over a loader, in loader order. For a
    model returning a tuple, output ``head`` (default the last) is used;
    for two-column targets, the action column."""
    preds, labels = [], []
    with torch.no_grad():
        for i, (x, y) in enumerate(loader):
            if isinstance(y, (tuple, list)):
                y = y[-1]
            if y.ndim == 2:
                y = y[:, 1]
            out = model(x)
            if isinstance(out, tuple):
                out = out[head if head is not None else -1]
            preds.append(out.argmax(-1).cpu().numpy())
            labels.append(y.cpu().numpy())
            if verbose:
                acc = float((preds[-1] == labels[-1]).mean())
                print(f"batch {i}/{len(loader)} - batch acc: {acc}")
    return np.concatenate(preds), np.concatenate(labels)


def calculate_accuracy(model, data_iterator: dict, key: str = "val_dataloader",
                       head: int | None = None) -> float:
    """Accuracy over the split ``key`` of a loaders dict."""
    preds, labels = predictions_and_labels(model, data_iterator[key], head)
    return float((preds == labels).mean())


def save_predictions(model, loader, out_path: str = "predWlabels.npy",
                     head: int | None = None) -> Path:
    """Dump ``{"predicted", "labels"}`` as a pickled numpy object."""
    preds, labels = predictions_and_labels(model, loader, head, verbose=True)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, {"predicted": preds, "labels": labels}, allow_pickle=True)
    print(f"accuracy total: {(preds == labels).sum()}/{len(labels)}")
    return out


def action_histogram(labels: np.ndarray, n_classes: int = 9) -> np.ndarray:
    return np.bincount(np.asarray(labels).astype(int), minlength=n_classes)


def sample_output_plot(model, loader, out_path: str, n_classes: int = 9,
                       head: int | None = None) -> Path:
    """Predicted-vs-label action histogram PNG."""
    preds, labels = predictions_and_labels(model, loader, head)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.arange(n_classes)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(x - 0.2, action_histogram(labels, n_classes), width=0.4, label="labels")
    ax.bar(x + 0.2, action_histogram(preds, n_classes), width=0.4, label="predicted")
    ax.set_xlabel("discrete action class")
    ax.set_ylabel("count")
    ax.set_xticks(x)
    ax.legend()
    ax.set_title("action distribution: labels vs predictions")
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def confusion_matrix(labels, preds, n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(labels).astype(int), np.asarray(preds).astype(int)), 1)
    return cm


def per_class_prf(labels, preds, n_classes: int):
    """→ (precision, recall, f1) arrays of shape (n_classes,)."""
    cm = confusion_matrix(labels, preds, n_classes)
    tp = np.diag(cm).astype(np.float64)
    precision = tp / np.maximum(cm.sum(axis=0), 1)
    recall = tp / np.maximum(cm.sum(axis=1), 1)
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-12)
    return precision, recall, f1

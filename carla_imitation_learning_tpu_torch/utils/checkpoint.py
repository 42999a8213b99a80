"""Checkpoints with best-k retention (the JAX package's
``utils/checkpoint.py``, with ``torch.save`` in place of Orbax).

A checkpoint is a directory, ``<filename>-step<N>`` for the manager's, that
holds one ``checkpoint.pt``: the ``Trainer``'s payload ``{"params": model
state_dict, "opt_state": optimizer state_dict, "step": int[, "ema_params":
EMA state_dict]}``, or any tree of tensors and plain values
(``save_pytree``). Loading uses ``torch.load(weights_only=True)``, which
unpickles tensors and plain containers only. The manager keeps the same
``index.json`` as the JAX package's and the same top-k, NaN and
``save_last`` rules. A JAX checkpoint reaches this format through
``convert.checkpoint_from_jax``.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path
from typing import Any

import torch

PAYLOAD_NAME = "checkpoint.pt"


def save_pytree(path: str | Path, tree: Any) -> None:
    """Write ``tree`` as checkpoint directory ``path``, replacing it."""
    p = Path(path).resolve()
    if p.exists():
        shutil.rmtree(p)
    p.mkdir(parents=True)
    torch.save(tree, p / PAYLOAD_NAME)


def restore_pytree(path: str | Path, target: Any = None) -> Any:
    """The tree saved at ``path``, on the CPU. With a ``target`` dict, its
    keys must be the saved tree's."""
    tree = torch.load(Path(path).resolve() / PAYLOAD_NAME, map_location="cpu",
                      weights_only=True)
    if isinstance(target, dict) and set(target) != set(tree):
        raise ValueError(f"checkpoint {path} holds {sorted(tree)}, "
                         f"expected {sorted(target)}")
    return tree


def restore_params(path: str | Path, template: dict) -> dict:
    """Model weights from either payload form, params-only (``{"params":
    ...}``) or a training checkpoint, as a state_dict cast onto the dtypes
    and devices of ``template`` (a model's ``state_dict()``). The EMA
    shadow is preferred where the checkpoint has one: best-k ranks on the
    EMA's validation metric, so it is the set that was scored. A missing or
    extra key, or a shape that differs from the template's, raises."""
    raw = restore_pytree(path)
    src = raw["ema_params"] if "ema_params" in raw else raw.get("params", raw)
    if set(src) != set(template) and isinstance(src.get("params"), dict):
        src = src["params"]
    if set(src) != set(template):
        raise ValueError(
            f"checkpoint {path} has keys {sorted(set(src) ^ set(template))} "
            "that the model does not match")
    out = {}
    for name, t in template.items():
        a = src[name]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(
                f"checkpoint {path} leaf {name} has shape {tuple(a.shape)} but the "
                f"model expects {tuple(t.shape)}: wrong n_actions, frame_skip or "
                "policy_family for this checkpoint?")
        out[name] = a.to(dtype=t.dtype, device=t.device)
    return out


class BestKCheckpointManager:
    """Keeps the ``save_top_k`` best checkpoints on ``monitor`` (``mode``
    "min" or "max"), listed in ``index.json``; a NaN score is never kept.
    ``save_last`` also writes ``<filename>-last`` on every call."""

    def __init__(
        self,
        directory: str | Path,
        monitor: str = "val_loss",
        mode: str = "min",
        save_top_k: int = 1,
        save_last: bool = False,
        filename: str = "ckpt",
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.filename = filename
        self._index_path = self.directory / "index.json"
        self._index: list[dict] = []
        if self._index_path.exists():
            self._index = json.loads(self._index_path.read_text())

    def _score(self, metrics: dict) -> float:
        v = float(metrics.get(self.monitor, math.nan))
        return v if self.mode == "min" else -v

    def _write_index(self) -> None:
        self._index_path.write_text(json.dumps(self._index, indent=1))

    def save(self, step: int, state: Any, metrics: dict) -> Path | None:
        """Save if within top-k on the monitored metric; prune the worst."""
        score = self._score(metrics)
        path = self.directory / f"{self.filename}-step{step}"
        kept = [e for e in self._index if not e.get("is_last")]
        keep = len(kept) < self.save_top_k or score < max(e["score"] for e in kept)
        if keep and not math.isnan(score):
            save_pytree(path, state)
            self._index.append({
                "step": int(step), "score": score, "path": str(path),
                "metric": float(metrics.get(self.monitor, math.nan)),
            })
            ranked = sorted([e for e in self._index if not e.get("is_last")],
                            key=lambda e: e["score"])
            for e in ranked[self.save_top_k:]:
                self._index.remove(e)
                shutil.rmtree(e["path"], ignore_errors=True)
            self._write_index()
        else:
            path = None
        if self.save_last:
            save_pytree(self.directory / f"{self.filename}-last", state)
        return path

    @property
    def best(self) -> dict | None:
        ranked = sorted([e for e in self._index if not e.get("is_last")],
                        key=lambda e: e["score"])
        return ranked[0] if ranked else None

    def restore(self, target: Any = None, path: str | Path | None = None) -> Any:
        """The best checkpoint's tree (or the one at ``path``)."""
        if path is None:
            best = self.best
            if best is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
            path = best["path"]
        return restore_pytree(path, target)

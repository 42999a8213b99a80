"""Metrics sinks (the JAX package's ``utils/logging.py``): JSONL and CSV
always, TensorBoard by default (``utils/tb_writer.py``), wandb when asked
for and importable. Fed on the host with the values the trainer already
copied back once per epoch.
"""

from __future__ import annotations

import csv
import json
import os
import time
from pathlib import Path
from typing import Mapping


def _to_float(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


class MetricLogger:
    def __init__(self, log_dir: str | os.PathLike, name: str = "run",
                 use_tensorboard: bool = True, use_wandb: bool = False):
        self.log_dir = Path(log_dir) / name
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a", buffering=1)
        self._csv_path = self.log_dir / "metrics.csv"
        self._csv_file = None
        self._csv_writer = None
        self._csv_fields: list[str] = []
        self._tb = None
        if use_tensorboard:
            from carla_imitation_learning_tpu_torch.utils.tb_writer import TBEventWriter

            self._tb = TBEventWriter(str(self.log_dir))
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            self._wandb = wandb
        self.history: list[dict] = []

    def add_scalar(self, tag: str, value, step: int) -> None:
        self.add_scalars_flat({tag: value}, step)

    def add_scalars(self, main_tag: str, scalars: Mapping[str, float], step: int) -> None:
        """``add_scalars('losses', {'train_loss': x}, epoch)`` → ``losses/train_loss``."""
        self.add_scalars_flat({f"{main_tag}/{k}": v for k, v in scalars.items()}, step)

    def add_scalars_flat(self, scalars: Mapping[str, float], step: int) -> None:
        row = {"step": int(step), "time": time.time()}
        row.update({k: _to_float(v) for k, v in scalars.items()})
        self.history.append(row)
        self._jsonl.write(json.dumps(row) + "\n")
        self._write_csv(row)
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, int(step))
        if self._wandb is not None and getattr(self._wandb, "run", None):
            self._wandb.log(dict(scalars), step=int(step))

    def _write_csv(self, row: dict) -> None:
        fields = sorted(set(self._csv_fields) | set(row.keys()))
        if fields != self._csv_fields:
            # schema grew: rewrite header by starting a fresh writer
            self._csv_fields = fields
            if self._csv_file is not None:
                self._csv_file.close()
            exists = self._csv_path.exists()
            self._csv_file = open(self._csv_path, "a", newline="", buffering=1)
            self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=fields,
                                              extrasaction="ignore")
            if not exists:
                self._csv_writer.writeheader()
        self._csv_writer.writerow(row)

    def close(self) -> None:
        self._jsonl.close()
        if self._csv_file is not None:
            self._csv_file.close()
        if self._tb is not None:
            self._tb.close()

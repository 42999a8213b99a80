"""VAE datasets (the JAX package's ``data/vae_data.py``): pooled and
leave-one-out splits over grayscale frames of one camera.

Frames of a log come from the first tier present: the reference's
``raw/<log>/<camera>_resized_<h>_bw`` folder (the only one guaranteed to be
at the configured ``image_size``), the packed ``raw/<log>/<camera>.tpuilfs``
(read through this package's ``native`` frame store), then the raw
``raw/<log>/<camera>`` folder. ``pooled_data`` splits the pooled
``train_logs`` at random into test / val / train; ``leave_one_out_data``
splits them into val / train and tests on ``test_logs``. The permutations
are ``np.random.default_rng(data_seed)``'s, as in the JAX package.
Batches are (B, H, W, 1) float32 in [0, 1] on ``device``; with a
``sharding`` (``parallel.mesh.batch_sharding``) each rank holds the whole
split and yields its rows of every global batch.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.data import frame_log as fl
from carla_imitation_learning_tpu_torch.device import resolve_device


class ImageDataset:
    """Unlabelled image batches over an (N, H, W) uint8 array, uploaded once
    to ``device``. A sharded loader drops its partial batch, as the JAX
    package's does."""

    def __init__(self, frames: np.ndarray, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 device: str | torch.device = "cuda", sharding=None):
        from carla_imitation_learning_tpu_torch.data.pipeline import _check_sharding

        self.device = resolve_device(device)
        self.sharding = _check_sharding(sharding)
        self.frames = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last or sharding is not None
        self._rng = np.random.default_rng(seed)
        self.n = len(frames)

    def __len__(self) -> int:
        if self.drop_last and self.n >= self.batch_size:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[torch.Tensor]:
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if self.sharding is not None:
                idx = idx[self.sharding.rows(len(idx))]
            x = self.frames[torch.from_numpy(idx).to(self.device)].to(torch.float32) / 255.0
            yield x[..., None]


def _image_h(cfg) -> int:
    size = cfg.get("image_size") or [1, 224, 224]
    return size[1] if isinstance(size, (list, tuple)) else 224


def _camera_dir(data_dir: Path, log: str, camera: str, h: int) -> Path:
    """The reference's ``<camera>_resized_<h>_bw`` folder, else the raw one."""
    resized = data_dir / "raw" / log / f"{camera}_resized_{h}_bw"
    return resized if resized.is_dir() else data_dir / "raw" / log / camera


def _load_frames(cfg, logs, camera: str) -> np.ndarray:
    """Every log's frames of ``camera``, concatenated, from the first tier
    present (see the module docstring). A packed file that does not open
    falls through to the per-file folders."""
    data_dir = Path(cfg["data_dir"])
    h = _image_h(cfg)
    parts = []
    for log in logs:
        resized = data_dir / "raw" / log / f"{camera}_resized_{h}_bw"
        packed = data_dir / "raw" / log / f"{camera}.tpuilfs"
        if packed.exists() and not resized.is_dir():
            from carla_imitation_learning_tpu_torch.native import NativeFrameStore

            try:
                nfs = NativeFrameStore(packed)
            except OSError:
                nfs = None
            if nfs is not None:
                parts.append(np.array(nfs.frames))
                nfs.close()
                continue
        parts.append(fl.FrameLog(_camera_dir(data_dir, log, camera, h)).read_all_gray_u8())
    return np.concatenate(parts, axis=0)


def get_pooled_data(cfg, camera: str) -> dict[str, np.ndarray]:
    """``train_logs`` pooled, permuted, split into test (``TEST_SIZE``),
    val (``VALID_SIZE``) and train."""
    frames = _load_frames(cfg, cfg["train_logs"], camera)
    idx = np.random.default_rng(int(cfg.get("data_seed", 0))).permutation(len(frames))
    n_test = int(float(cfg["TEST_SIZE"]) * len(frames))
    n_val = int(float(cfg["VALID_SIZE"]) * len(frames))
    test_id, val_id, train_id = np.split(idx, [n_test, n_test + n_val])
    return {"train": frames[train_id], "val": frames[val_id], "test": frames[test_id]}


def get_leave_out_data(cfg, camera: str) -> dict[str, np.ndarray]:
    """val (``VALID_SIZE``) and train from ``train_logs``; test is
    ``test_logs``."""
    frames = _load_frames(cfg, cfg["train_logs"], camera)
    idx = np.random.default_rng(int(cfg.get("data_seed", 0))).permutation(len(frames))
    n_val = int(float(cfg["VALID_SIZE"]) * len(frames))
    val_id, train_id = np.split(idx, [n_val])
    return {"train": frames[train_id], "val": frames[val_id],
            "test": _load_frames(cfg, cfg["test_logs"], camera)}


def train_val_test_iterator(cfg, data_split_type: str = "pooled_data",
                            device: str | torch.device = "cuda", sharding=None) -> dict:
    """{'train_dataloader', 'val_dataloader', 'test_dataloader'} over the
    first configured camera; train shuffles from ``seed`` and takes the
    ``sharding``."""
    camera = cfg["camera"] if isinstance(cfg["camera"], str) else cfg["camera"][0]
    get_data = {"pooled_data": get_pooled_data, "leave_one_out_data": get_leave_out_data}
    data = get_data[data_split_type](cfg, camera)
    bs = int(cfg["BATCH_SIZE"])
    return {
        "train_dataloader": ImageDataset(data["train"], bs, shuffle=True,
                                         seed=int(cfg.get("seed", 0)), device=device,
                                         sharding=sharding),
        "val_dataloader": ImageDataset(data["val"], bs, device=device),
        "test_dataloader": ImageDataset(data["test"], bs, device=device),
    }

"""Device-resident input pipeline (the JAX package's ``data/pipeline.py``).

A split's grayscale frames are packed once into a contiguous uint8 array
(``FrameStore``, numpy, the format both packages share) and uploaded once
to the card by ``DeviceDataset``; every training batch is then a gather on
the device:

    x = frames[idx[:, None] + arange(frame_skip)]  →  (B, H, W, frame_skip)

normalised with a multiply by 1/255. Only the index vector crosses from
the host, once per batch, or once per epoch as an (n_batches, B) matrix
for the fused epoch (``training.steps.make_fused_epoch``).

Window semantics: window = frames[k : k + frame_skip], label =
action[k + label_offset] (``frame_skip`` by default); a window never
crosses an episode start (``FrameStore.starts``). The epoch order comes
from ``np.random.default_rng(seed)`` with the same calls as the JAX
package, so both draw the same windows.

Stores load from the frame-log files (``FrameStore.from_processed_dir``,
``from_raw_camera``), and the iterator factories build the train / val /
test datasets of the sequential (plain, aux and dual-stream), pooled and
large layouts. ``AuxSegDataset`` adds per-pixel class labels to aux
batches and ``PairedStreamDataset`` a second camera's windows.
``device_prefetch`` copies host batches to the card ahead of the consumer.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.data import actions as action_lib
from carla_imitation_learning_tpu_torch.data import frame_log as fl
from carla_imitation_learning_tpu_torch.device import resolve_device


@dataclasses.dataclass
class FrameStore:
    """Packed frames + aligned targets for one split (numpy arrays).

    frames:  (N, H, W) uint8 luminance (or float32 in [0, 1]).
    actions: (N,) int32 discrete action per frame.
    traffic: (N,) int32 red-light status per frame.
    sensors: (N, 3) float32 ``(current_steer, speed_long, speed)``.
    commands: (N,) navigation commands, optional.
    starts:  (N,) bool, True where a frame begins a new episode or stream;
             None for one uninterrupted stream.
    file_idx: (N,) 0-based raw-log frame id, optional.
    controls: (N, 2) float32 expert (steer, accel), optional.
    """

    frames: np.ndarray
    actions: np.ndarray
    traffic: np.ndarray
    sensors: np.ndarray
    commands: np.ndarray | None = None
    starts: np.ndarray | None = None
    file_idx: np.ndarray | None = None
    controls: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.frames)

    @property
    def height(self) -> int:
        return self.frames.shape[1]

    @property
    def width(self) -> int:
        return self.frames.shape[2]

    @classmethod
    def from_arrays(cls, frames: np.ndarray, state: fl.StateLog, file_idx=None,
                    starts: np.ndarray | None = None) -> "FrameStore":
        """Align a (N, H, W) frame array with a StateLog via 0-based file indices."""
        if file_idx is None:
            file_idx = np.arange(len(frames))
        acts = action_lib.continuous_to_discrete(
            torch.from_numpy(np.asarray(state.steer)),
            torch.from_numpy(np.asarray(state.throttle)),
            torch.from_numpy(np.asarray(state.brake))).numpy().astype(np.int32)
        return cls(
            frames=frames,
            actions=acts[file_idx],
            traffic=np.asarray(state.trafficlight).astype(np.int32)[file_idx],
            sensors=state.sensors[file_idx],
            starts=starts,
            file_idx=np.asarray(file_idx),
        )

    @classmethod
    def from_frame_log(cls, frame_dir, state_path) -> "FrameStore":
        """Frames of a ``FrameLog`` folder aligned with a state.csv."""
        flog = fl.FrameLog(frame_dir)
        return cls.from_arrays(flog.read_all_gray_u8(), fl.load_state_csv(state_path),
                               flog.file_idx)

    @classmethod
    def from_processed_dir(cls, cfg, split: str, log: str | None = None) -> "FrameStore":
        """Load the processed sequential layout
        ``<data_dir>/processed/<log>/<split>/<log>/`` with the log's
        state.csv; without that folder, the configured camera's folder
        under the split, else the split's sole subfolder."""
        log = log or cfg["train_logs"][0]
        data_dir = Path(cfg["data_dir"])
        split_dir = data_dir / "processed" / log / split
        frame_dir = split_dir / log
        if not frame_dir.is_dir():
            camera = cfg.get("camera")
            camera = camera[0] if isinstance(camera, list) else camera
            cam_dir = split_dir / str(camera)
            if cam_dir.is_dir():
                frame_dir = cam_dir
            else:
                subdirs = [p for p in split_dir.iterdir() if p.is_dir()]
                if len(subdirs) != 1:
                    raise FileNotFoundError(
                        f"expected {frame_dir}, {cam_dir}, or exactly one frame "
                        f"folder, got {subdirs}")
                frame_dir = subdirs[0]
        return cls.from_frame_log(frame_dir, state_csv_path(data_dir, log))

    @classmethod
    def from_raw_camera(cls, cfg, log: str, camera: str) -> "FrameStore":
        """Load straight from ``<data_dir>/raw/<log>/<camera>/``."""
        data_dir = Path(cfg["data_dir"])
        return cls.from_frame_log(data_dir / "raw" / log / camera,
                                  state_csv_path(data_dir, log))

    @classmethod
    def synthetic(cls, n: int = 64, height: int = 64, width: int = 64,
                  seed: int = 0) -> "FrameStore":
        state = fl.make_synthetic_state(n, seed)
        rgb = fl.synthetic_frames(n, height, width, seed)
        gray = np.round(rgb[..., :3].astype(np.float64) @ fl.LUMA).astype(np.uint8)
        return cls.from_arrays(gray, state)

    def slice(self, start: int, stop: int) -> "FrameStore":
        starts = None
        if self.starts is not None:
            starts = self.starts[start:stop].copy()
            if len(starts):
                starts[0] = True
        return FrameStore(
            self.frames[start:stop], self.actions[start:stop],
            self.traffic[start:stop], self.sensors[start:stop],
            None if self.commands is None else self.commands[start:stop],
            starts,
            None if self.file_idx is None else self.file_idx[start:stop],
            None if self.controls is None else self.controls[start:stop],
        )

    @classmethod
    def concat(cls, stores: list["FrameStore"]) -> "FrameStore":
        """Concatenate stores, marking each store's first frame as an episode
        start so windows never straddle a store boundary."""
        starts = []
        for s in stores:
            st = (s.starts.copy() if s.starts is not None
                  else np.zeros(len(s), bool))
            if len(st):
                st[0] = True
            starts.append(st)
        all_cmd = all(s.commands is not None for s in stores)
        all_ctl = all(s.controls is not None for s in stores)
        return cls(
            frames=np.concatenate([s.frames for s in stores]),
            actions=np.concatenate([s.actions for s in stores]),
            traffic=np.concatenate([s.traffic for s in stores]),
            sensors=np.concatenate([s.sensors for s in stores]),
            commands=(np.concatenate([s.commands for s in stores])
                      if all_cmd else None),
            starts=np.concatenate(starts),
            controls=(np.concatenate([s.controls for s in stores])
                      if all_ctl else None),
        )


def state_csv_path(data_dir: Path, log: str) -> Path:
    """``raw/<log>/state.csv``, else ``raw/state.csv``."""
    path = data_dir / "raw" / log / "state.csv"
    return path if path.exists() else data_dir / "raw" / "state.csv"


def gather_windows(frames: torch.Tensor, idx: torch.Tensor, frame_skip: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, H, W) frames + (B,) start indices → (B, H, W, frame_skip) windows.

    uint8 frames are normalised as ``x.to(dtype) * (1/255)``, a multiply as
    in the JAX package, with the constant rounded to ``dtype`` first as
    JAX's weak-typed constant is, so the batches agree bit for bit. The
    result is a permuted view of the gathered (B, frame_skip, H, W) block,
    the layout the policy's trunk reads."""
    windows = frames[idx[:, None] + torch.arange(frame_skip, device=idx.device)[None, :]]
    x = windows.permute(0, 2, 3, 1)
    if frames.dtype == torch.uint8:
        return x.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype)
    return x.to(dtype)


def valid_window_starts(n_frames: int, starts: np.ndarray | None, span: int,
                        n_starts: int | None = None) -> np.ndarray:
    """Window-start indices whose span stays inside one episode.

    A window starting at i touches frames (i, i + span]; it is dropped if
    any of those frames begins a new episode (``starts`` bitmap)."""
    n = n_starts if n_starts is not None else n_frames - span
    base = np.arange(max(n, 0), dtype=np.int32)
    if starts is None or span <= 0 or len(base) == 0:
        return base
    st = np.asarray(starts, bool)
    crosses = np.zeros(len(base), bool)
    for d in range(1, span + 1):
        crosses |= st[d:d + len(base)]
    return base[~crosses]


class DeviceDataset:
    """Iterator over on-device ``(x, y)`` batches from a FrameStore:
    x (B, H, W, frame_skip) in ``dtype``, y (B,) int64 actions; with
    ``cil=True`` ``(x, speed (B,) float32, command (B,) int64, y)`` of the
    labelled frame; with ``aux=True`` ``((x, sensor (B, 3) float32), (B, 2)
    int32 (traffic, action))``; with ``continuous_labels`` (an (n_frames,
    d) float array aligned with the store) ``(x, the labelled frame's row)``.

    ``label_offset`` (default ``frame_skip``) picks the labeled frame;
    ``sample_mask`` keeps only windows whose labeled frame it marks;
    ``balanced`` draws each epoch's ``n_samples`` windows with replacement,
    weighted by the inverse frequency of ``balance_key`` ("action",
    "command" or "action_command"). Frames, labels and the valid-start map
    live on ``device`` (default the card)."""

    def __init__(
        self,
        store: FrameStore,
        batch_size: int,
        frame_skip: int = 4,
        shuffle: bool = False,
        seed: int = 0,
        aux: bool = False,
        drop_last: bool = True,
        dtype: str = "float32",
        sharding=None,
        label_offset: int | None = None,
        cil: bool = False,
        sample_mask: np.ndarray | None = None,
        balanced: bool = False,
        balance_key: str = "action",
        continuous_labels: np.ndarray | None = None,
        extra_frames: "list[np.ndarray] | None" = None,
        device: str | torch.device = "cuda",
    ):
        unported = {"sharding": sharding is not None, "extra_frames": bool(extra_frames)}
        if any(unported.values()):
            raise NotImplementedError(
                f"batch kinds not ported yet: {[k for k, v in unported.items() if v]}")
        cont = None
        if continuous_labels is not None:
            if aux or cil:
                raise ValueError("continuous_labels is exclusive with aux/cil batches")
            cont = np.asarray(continuous_labels, np.float32)
            if cont.ndim != 2 or cont.shape[0] != len(store):
                raise ValueError(
                    f"continuous_labels must be (n_frames, d); got "
                    f"{cont.shape} for a {len(store)}-frame store")
        self.device = resolve_device(device)
        self.aux = aux
        self.cil = cil
        self.store = store
        self.batch_size = batch_size
        self.frame_skip = frame_skip
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.dtype = getattr(torch, dtype)
        self._rng = np.random.default_rng(seed)
        self.label_offset = frame_skip if label_offset is None else label_offset
        span = max(frame_skip - 1, self.label_offset)
        n_starts = len(store) - span
        if n_starts <= 0:
            raise ValueError(
                f"store with {len(store)} frames too small for frame_skip={frame_skip}")
        valid = valid_window_starts(len(store), store.starts, span, n_starts=n_starts)
        if len(valid) == 0:
            raise ValueError("no episode is long enough for a full window")
        if sample_mask is not None:
            mask = np.asarray(sample_mask, bool)
            if mask.shape[0] != len(store):
                raise ValueError(
                    f"sample_mask has {mask.shape[0]} entries for a "
                    f"{len(store)}-frame store")
            valid = valid[mask[valid + self.label_offset]]
            if len(valid) == 0:
                raise ValueError("sample_mask excludes every training window")
        self.n_samples = len(valid)
        self._balance_p = None
        if balanced:
            self._balance_p = self._balance_weights(store, valid, balance_key)
        # sample index → window start: identity when every start is valid
        self._valid_starts = (None if len(valid) == n_starts
                              else self._put(valid.astype(np.int64)))
        self.frames = self._put(store.frames)
        self.actions = self._put(store.actions.astype(np.int64))
        self.continuous = None if cont is None else self._put(cont)
        if aux:
            self.sensors = self._put(np.asarray(store.sensors, np.float32))
            self.traffic = self._put(store.traffic.astype(np.int64))
        if cil:
            commands = (store.commands if store.commands is not None
                        else np.zeros(len(store), np.int64))
            self.speeds = self._put(np.asarray(store.sensors, np.float32)[:, 2])
            self.commands = self._put(commands.astype(np.int64))

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _balance_weights(self, store: FrameStore, valid: np.ndarray,
                         balance_key: str) -> np.ndarray:
        labeled = valid + self.label_offset
        actions_l = np.asarray(store.actions, np.int64)[labeled]
        if balance_key != "action":
            cmds = (np.asarray(store.commands, np.int64)[labeled]
                    if store.commands is not None
                    else np.zeros(len(labeled), np.int64))
        if balance_key == "action":
            keys = actions_l
        elif balance_key == "command":
            keys = cmds
        elif balance_key == "action_command":
            _, keys = np.unique(np.stack([actions_l, cmds], axis=1), axis=0,
                                return_inverse=True)
            keys = keys.reshape(-1)
        else:
            raise ValueError(
                f"balance_key={balance_key!r}: expected 'action', "
                "'command', or 'action_command'")
        counts = np.bincount(keys)
        w = 1.0 / counts[keys]
        return w / w.sum()

    def __len__(self) -> int:
        if self.drop_last and self.n_samples >= self.batch_size:
            return self.n_samples // self.batch_size
        # never zero batches: fall back to a partial batch
        return -(-self.n_samples // self.batch_size)

    def epoch_indices(self) -> np.ndarray:
        if self._balance_p is not None:
            return self._rng.choice(self.n_samples, size=self.n_samples,
                                    replace=True, p=self._balance_p)
        order = np.arange(self.n_samples)
        if self.shuffle:
            self._rng.shuffle(order)
        return order

    def pure_batch(self, idx: torch.Tensor):
        """Batch from a device vector of sample indices in [0, n_samples)."""
        if self._valid_starts is not None:
            idx = self._valid_starts[idx]
        x = gather_windows(self.frames, idx, self.frame_skip, self.dtype)
        at = idx + self.label_offset
        if self.continuous is not None:
            return x, self.continuous[at]
        if self.cil:
            return x, self.speeds[at], self.commands[at], self.actions[at]
        if self.aux:
            y = torch.stack([self.traffic[at], self.actions[at]], dim=-1).to(torch.int32)
            return (x, self.sensors[at]), y
        return x, self.actions[at]

    def make_batch(self, idx: np.ndarray):
        return self.pure_batch(torch.as_tensor(np.asarray(idx, np.int64)).to(self.device))

    def fork(self, seed: int) -> "DeviceDataset":
        """Shallow copy with a fresh order generator, sharing the device arrays."""
        forked = copy.copy(self)
        forked._rng = np.random.default_rng(seed)
        return forked

    def start_indices(self, idx: np.ndarray) -> torch.Tensor:
        """Sample indices → episode-valid window start indices on the device."""
        idx = torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)
        if self._valid_starts is not None:
            idx = self._valid_starts[idx]
        return idx

    def __iter__(self) -> Iterator:
        order = self.epoch_indices()
        for b in range(len(self)):
            yield self.make_batch(order[b * self.batch_size:(b + 1) * self.batch_size])


# ---------------------------------------------------------------------------
# Iterator factories: each returns {'train_dataloader', 'val_dataloader',
# 'test_dataloader'}.
# ---------------------------------------------------------------------------

def _loaders_from_stores(cfg, stores: dict[str, FrameStore], aux: bool, frame_skip: int,
                         sharding=None, label_offset: int | None = None,
                         device: str | torch.device = "cuda") -> dict:
    """Train shuffles (``shuffle_train``) and drops its partial batch; val and
    test keep theirs, so small splits still give metrics. Balanced sampling
    (``balanced_sampling``) applies to train only."""
    batch = int(cfg["BATCH_SIZE"])
    shuffle = bool(cfg.get("shuffle_train", False))
    seed = int(cfg.get("seed", 0))
    out = {}
    for split, name in (("train", "train_dataloader"), ("val", "val_dataloader"),
                        ("test", "test_dataloader")):
        out[name] = DeviceDataset(
            stores[split], batch, frame_skip=frame_skip,
            shuffle=(shuffle and split == "train"), seed=seed, aux=aux,
            drop_last=(split == "train"),
            dtype=str(cfg.get("compute_dtype_input", "float32")),
            sharding=(sharding if split == "train" else None),
            label_offset=label_offset,
            balanced=(bool(cfg.get("balanced_sampling", False)) and split == "train"),
            device=device,
        )
    return out


def sequential_train_val_test_iterator(cfg, stores: dict[str, FrameStore] | None = None,
                                       sharding=None,
                                       device: str | torch.device = "cuda") -> dict:
    """BC datasets over ``frame_skip`` windows of the processed sequential
    split (``FrameStore.from_processed_dir``)."""
    stores = stores or {s: FrameStore.from_processed_dir(cfg, s)
                        for s in ("train", "val", "test")}
    return _loaders_from_stores(cfg, stores, aux=False, frame_skip=int(cfg["frame_skip"]),
                                sharding=sharding, device=device)


def sequential_aux_train_val_test_iterator(cfg, stores: dict[str, FrameStore] | None = None,
                                           sharding=None,
                                           device: str | torch.device = "cuda") -> dict:
    """Aux multi-task datasets, ``((frames, sensor), (traffic, action))``
    batches, over the same windows as ``sequential_train_val_test_iterator``."""
    stores = stores or {s: FrameStore.from_processed_dir(cfg, s)
                        for s in ("train", "val", "test")}
    return _loaders_from_stores(cfg, stores, aux=True, frame_skip=int(cfg["frame_skip"]),
                                sharding=sharding, device=device)


class PairedStreamDataset:
    """A DeviceDataset zipped with a second camera stream, frame-aligned
    with its store: ``(x, x_seg, y)`` batches for ``DualStreamCNN``, both
    windows gathered at the same episode-valid start indices.
    ``seg_frames`` must already be rebased to the store's positions
    (``rebase_stream``)."""

    def __init__(self, base: DeviceDataset, seg_frames: np.ndarray):
        if len(seg_frames) != len(base.store):
            raise ValueError(f"paired stream has {len(seg_frames)} frames for a "
                             f"{len(base.store)}-frame base store")
        self.base = base
        self.seg = base._put(np.asarray(seg_frames))
        self.batch_size = base.batch_size

    def __len__(self) -> int:
        return len(self.base)

    def __iter__(self) -> Iterator:
        order = self.base.epoch_indices()
        bs = self.base.batch_size
        for b in range(len(self.base)):
            idx = order[b * bs:(b + 1) * bs]
            x, y = self.base.make_batch(idx)
            xs = gather_windows(self.seg, self.base.start_indices(idx), self.base.frame_skip,
                                self.base.dtype)
            yield x, xs, y


class AuxSegDataset:
    """An aux DeviceDataset zipped with per-pixel class ids:
    ``((frames, sensor), (traffic, action), seg_labels (B, H, W) int32)``
    batches for ``AuxNet`` with its seg decoder. ``seg_frames`` (N, H, W)
    is the class-id stream of the same collection
    (``closed_loop.semantic_stream``), frame-aligned with the store, kept
    on the device in its own dtype; the seg label is the window's last
    frame (start + frame_skip − 1).

    ``speed_dropout``: the probability, per sample, of zeroing the speed
    columns (speed_long, speed) of its sensor vector, drawn from
    ``np.random.default_rng(seed)`` as in the JAX package; it keeps a
    speed-conditioned policy from learning "stopped, so brake"."""

    def __init__(self, base: DeviceDataset, seg_frames: np.ndarray,
                 speed_dropout: float = 0.0, seed: int = 0):
        if len(seg_frames) != len(base.store):
            raise ValueError(f"semantic stream has {len(seg_frames)} frames for a "
                             f"{len(base.store)}-frame base store")
        if not base.aux:
            raise ValueError("AuxSegDataset requires an aux=True base")
        self.base = base
        self.seg = base._put(np.asarray(seg_frames))
        self.batch_size = base.batch_size
        self.speed_dropout = float(speed_dropout)
        self._drop_rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.base)

    def speed_mask(self, n: int) -> np.ndarray:
        """The next batch's (n, 3) sensor mask: 1 for current_steer, the
        kept-speed flag for the two speed columns."""
        keep = self._drop_rng.random(n) >= self.speed_dropout
        return np.concatenate([np.ones((n, 1)), np.repeat(keep[:, None], 2, axis=1)], axis=1)

    def __iter__(self) -> Iterator:
        order = self.base.epoch_indices()
        bs = self.base.batch_size
        for b in range(len(self.base)):
            idx = order[b * bs:(b + 1) * bs]
            (frames, sensor), y = self.base.make_batch(idx)
            if self.speed_dropout > 0.0:
                mask = torch.from_numpy(self.speed_mask(sensor.shape[0]).astype(np.float32))
                sensor = sensor * mask.to(sensor.device)
            at = self.base.start_indices(idx) + self.base.frame_skip - 1
            yield (frames, sensor), y, self.seg[at].to(torch.int32)


def rebase_stream(frames: np.ndarray, frames_file_idx: np.ndarray,
                  target_file_idx: np.ndarray | None) -> np.ndarray:
    """The frames of a whole-log array whose raw-log ids are
    ``target_file_idx``, in that order: pairs a second camera with a split
    store frame for frame (the val and test splits sit at 80–90 % and
    90–100 % of the log, so pairing by position would be wrong)."""
    if target_file_idx is None:
        return frames[:]
    pos = np.searchsorted(frames_file_idx, target_file_idx)
    pos = np.clip(pos, 0, len(frames_file_idx) - 1)
    if not np.array_equal(np.asarray(frames_file_idx)[pos], target_file_idx):
        raise ValueError("paired stream is missing frames present in the base camera log")
    return frames[pos]


def paired_sequential_iterator(cfg, sharding=None,
                               device: str | torch.device = "cuda") -> dict:
    """Dual-stream datasets: the sequential split's stores zipped with the
    ``semantic`` camera of the same log, aligned by raw frame id (without a
    semantic camera, each store is paired with itself)."""
    stores = {s: FrameStore.from_processed_dir(cfg, s) for s in ("train", "val", "test")}
    sem_dir = Path(cfg["data_dir"]) / "raw" / cfg["train_logs"][0] / "semantic"
    sem_full = sem_file_idx = None
    if sem_dir.is_dir():
        sem_log = fl.FrameLog(sem_dir)
        sem_full = sem_log.read_all_gray_u8()
        sem_file_idx = sem_log.file_idx
    out = {}
    for split, name in (("train", "train_dataloader"), ("val", "val_dataloader"),
                        ("test", "test_dataloader")):
        base = DeviceDataset(stores[split], int(cfg["BATCH_SIZE"]),
                             frame_skip=int(cfg["frame_skip"]), drop_last=(split == "train"),
                             dtype=str(cfg.get("compute_dtype_input", "float32")),
                             sharding=(sharding if split == "train" else None),
                             device=device)
        seg = (stores[split].frames if sem_full is None
               else rebase_stream(sem_full, sem_file_idx, stores[split].file_idx))
        out[name] = PairedStreamDataset(base, seg)
    return out


def _pooled_split(cfg, store: FrameStore) -> dict[str, FrameStore]:
    """Sequential (1 - 2t, t, t) split over pooled frames, t = ``TEST_SIZE``."""
    t = float(cfg["TEST_SIZE"])
    n = len(store)
    i1, i2 = int((1 - 2 * t) * n), int((1 - t) * n)
    return {"train": store.slice(0, i1), "val": store.slice(i1, i2),
            "test": store.slice(i2, n)}


def train_val_test_iterator(cfg, data_split_type: str = "pooled_data", sharding=None,
                            device: str | torch.device = "cuda") -> dict:
    """Pooled single-frame datasets over every ``train_logs`` log's raw
    camera folder (windows of one frame, labelled by that frame)."""
    camera = cfg["camera"][0] if isinstance(cfg["camera"], list) else cfg["camera"]
    per_log = [FrameStore.from_raw_camera(cfg, log, camera) for log in cfg["train_logs"]]
    pooled = FrameStore(
        frames=np.concatenate([s.frames for s in per_log]),
        actions=np.concatenate([s.actions for s in per_log]),
        traffic=np.concatenate([s.traffic for s in per_log]),
        sensors=np.concatenate([s.sensors for s in per_log]),
    )
    return _loaders_from_stores(cfg, _pooled_split(cfg, pooled), aux=False, frame_skip=1,
                                sharding=sharding, label_offset=0, device=device)


def large_train_val_test_iterator(cfg, sharding=None,
                                  device: str | torch.device = "cuda") -> dict:
    """Single-frame datasets over the processed per-camera layout
    ``processed/<log>/<split>/<camera>/``."""
    log = cfg["train_logs"][0]
    camera = cfg["camera"][0] if isinstance(cfg["camera"], list) else cfg["camera"]
    data_dir = Path(cfg["data_dir"])
    state_path = state_csv_path(data_dir, log)
    stores = {split: FrameStore.from_frame_log(data_dir / "processed" / log / split / camera,
                                               state_path)
              for split in ("train", "val", "test")}
    return _loaders_from_stores(cfg, stores, aux=False, frame_skip=1, sharding=sharding,
                                label_offset=0, device=device)


def device_prefetch(iterator, size: int = 2, transform=None,
                    device: str | torch.device = "cuda"):
    """Copy host batches (tuples of numpy arrays or tensors) to ``device``
    ``size`` batches ahead of the consumer, so the copy of batch i + 1 runs
    under the work queued for batch i.

    On the card each array is pinned and copied with ``non_blocking=True``
    on a side stream; a batch is handed out after the consumer's stream
    waits for its copy, and ``record_stream`` keeps the caching allocator
    from reusing its memory while that stream still reads it.
    ``transform(batch)`` runs on the host before the copy."""
    dev = resolve_device(device)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch):
        if transform is not None:
            batch = transform(batch)
        host = [torch.as_tensor(a) for a in batch]
        if copy_stream is None:
            return tuple(t.to(dev) for t in host), None
        host = [t.pin_memory() for t in host]
        with torch.cuda.stream(copy_stream):
            out = tuple(t.to(dev, non_blocking=True) for t in host)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def take(entry):
        out, done = entry
        if done is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(done)
            for t in out:
                t.record_stream(stream)
        return out

    queue = collections.deque()
    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= size:
            yield take(queue.popleft())
    while queue:
        yield take(queue.popleft())

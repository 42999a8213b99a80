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
"""

from __future__ import annotations

import copy
import dataclasses
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
    def from_processed_dir(cls, cfg, split: str, log: str | None = None) -> "FrameStore":
        raise NotImplementedError("frame-log file IO is not ported yet")

    @classmethod
    def from_raw_camera(cls, cfg, log: str, camera: str) -> "FrameStore":
        raise NotImplementedError("frame-log file IO is not ported yet")

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
    x (B, H, W, frame_skip) in ``dtype``, y (B,) int64 actions.

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
        unported = {"aux": aux, "cil": cil, "sharding": sharding is not None,
                    "continuous_labels": continuous_labels is not None,
                    "extra_frames": bool(extra_frames)}
        if any(unported.values()):
            raise NotImplementedError(
                f"batch kinds not ported yet: {[k for k, v in unported.items() if v]}")
        self.device = resolve_device(device)
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
        return x, self.actions[idx + self.label_offset]

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

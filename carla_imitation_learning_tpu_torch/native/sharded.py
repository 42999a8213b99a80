"""Sharded frame stores: a dataset split over several packed files (the JAX
package's ``native/sharded.py``, with the same file layout and the same
random streams).

- ``save_sharded_framestore`` cuts a ``FrameStore`` into shard files of
  about ``shard_frames`` frames, at episode starts when the store has them,
  and writes an ``index.json`` manifest;
- ``ShardedFrameStore`` reads the manifest and maps one shard at a time;
- ``ShardedPrefetchReader`` visits the shards in a fresh order every epoch
  (``default_rng(seed + epoch)``) and the C++ reader shuffles windows
  inside each (seed ``seed + 1000 * epoch + shard``, ``epoch`` counted from
  1);
- ``DeviceShardStreamer`` copies each shard's raw uint8 frames to the card
  once, from pinned memory on a side stream, the next shard's copy issued
  before the current shard's batches run, and gathers windows on the card.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.data.pipeline import (
    gather_windows, valid_window_starts,
)
from carla_imitation_learning_tpu_torch.device import resolve_device
from carla_imitation_learning_tpu_torch.native.framestore import (
    NativeFrameStore, PrefetchReader, save_framestore,
)

INDEX_NAME = "index.json"


def _cut_points(n: int, starts: np.ndarray | None, target: int
                ) -> tuple[list[int], bool]:
    """→ (ascending shard cuts, excluding 0 and n; aligned).

    Each cut is the largest episode start at most ``target`` frames past the
    previous cut; where no start lies in range the cut falls at the raw
    multiple and ``aligned`` comes back False."""
    cuts = []
    prev = 0
    aligned = starts is not None
    start_idx = (np.nonzero(np.asarray(starts, bool))[0]
                 if starts is not None else np.empty(0, np.int64))
    while n - prev > target:
        want = prev + target
        cands = start_idx[(start_idx > prev) & (start_idx <= want)]
        if len(cands):
            cut = int(cands[-1])
        else:
            cut = want
            aligned = False
        cuts.append(cut)
        prev = cut
    return cuts, aligned


def save_sharded_framestore(out_dir: str | os.PathLike, store,
                            shard_frames: int = 4096) -> Path:
    """Write ``store`` as ``shard-NNNNN.tpuilfs`` files plus the manifest;
    each shard is a packed store readable on its own."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(store.frames)
    cuts, aligned = _cut_points(n, store.starts, int(shard_frames))
    bounds = [0] + cuts + [n]
    shards = []
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        fname = f"shard-{i:05d}.tpuilfs"
        save_framestore(out / fname, store.slice(lo, hi))
        shards.append({"file": fname, "n": int(hi - lo)})
    manifest = {
        "version": 1,
        "height": int(store.frames.shape[1]),
        "width": int(store.frames.shape[2]),
        "n_frames": int(n),
        "aligned_to_starts": bool(aligned),
        "shards": shards,
    }
    (out / INDEX_NAME).write_text(json.dumps(manifest, indent=1))
    return out


class ShardedFrameStore:
    """Manifest view over a shard directory (no shard is opened until asked)."""

    def __init__(self, path: str | os.PathLike):
        self.dir = Path(path)
        manifest = json.loads((self.dir / INDEX_NAME).read_text())
        if manifest.get("version") != 1:
            raise ValueError(f"unknown shard manifest version: {manifest.get('version')}")
        self.height = manifest["height"]
        self.width = manifest["width"]
        self.n_frames = manifest["n_frames"]
        self.aligned_to_starts = manifest.get("aligned_to_starts", False)
        self.shards = manifest["shards"]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def open_shard(self, i: int) -> NativeFrameStore:
        """Map shard ``i`` (the caller closes it)."""
        return NativeFrameStore(self.dir / self.shards[i]["file"])

    def shard_frames(self, i: int) -> int:
        return self.shards[i]["n"]


class DeviceShardStreamer:
    """Frame store → card streaming with the window gather on the card.

    ``store`` is a ``ShardedFrameStore``, a shard directory or a single
    packed file (one shard). Yields ``(x (B, H, W, frame_skip) dtype in [0,
    1], y (B,) int64)`` batches on ``device`` (default the card). Window
    starts keep each shard's episode starts (``valid_window_starts``); per
    epoch the shard order and each shard's windows are shuffled with one
    ``default_rng(seed + epoch)``, as in the JAX package."""

    def __init__(self, store: "ShardedFrameStore | str | os.PathLike",
                 batch: int, frame_skip: int = 4, dtype: str = "float32",
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._single = None
        self.store = store if isinstance(store, ShardedFrameStore) else None
        if self.store is None:
            p = Path(store)
            if p.is_file():
                self._single = p
            else:
                self.store = ShardedFrameStore(p)
        self.batch = batch
        self.frame_skip = frame_skip
        self.dtype = getattr(torch, dtype)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def _shard_paths(self) -> list[Path]:
        if self._single is not None:
            return [self._single]
        return [self.store.dir / s["file"] for s in self.store.shards]

    def _load_shard(self, path: Path):
        """→ (frames, actions, copy-done event or None, valid starts). On the
        card the frames go from the map into pinned memory (one memcpy) and
        on to the card by a copy issued on the side stream."""
        with NativeFrameStore(path) as nfs:
            valid = valid_window_starts(nfs.n, nfs.starts, self.frame_skip)
            actions = torch.from_numpy(nfs.actions.astype(np.int64))
            if self._copy_stream is None:
                return torch.from_numpy(np.array(nfs.frames)), actions, None, valid
            pinned = torch.empty((nfs.n, nfs.h, nfs.w), dtype=torch.uint8,
                                 pin_memory=True)
            pinned.numpy()[...] = nfs.frames
        actions = actions.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            frames = pinned.to(self.device, non_blocking=True)
            actions = actions.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return frames, actions, done, valid

    def _ready(self, frames, actions, done):
        """Make the current stream wait for a shard's copy, and tell the
        caching allocator the tensors are used there."""
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            frames.record_stream(stream)
            actions.record_stream(stream)
        return frames, actions

    def device_shards(self):
        """Yield ``(frames, actions, shuffled window starts)`` per shard in
        epoch order, with the next shard's copy already issued."""
        paths = self._shard_paths()
        order = np.arange(len(paths))
        rng = np.random.default_rng(self.seed + self._epoch)
        if self.shuffle:
            rng.shuffle(order)
        self._epoch += 1
        pending = self._load_shard(paths[order[0]])
        for pos in range(len(order)):
            frames, actions, done, valid = pending
            frames, actions = self._ready(frames, actions, done)
            if pos + 1 < len(order):
                pending = self._load_shard(paths[order[pos + 1]])
            if len(valid) == 0:
                continue
            widx = valid.copy()
            if self.shuffle:
                rng.shuffle(widx)
            yield frames, actions, widx

    def _n_batches(self, n_windows: int) -> int:
        return (n_windows // self.batch if self.drop_last
                else -(-n_windows // self.batch))

    def __iter__(self):
        for frames, actions, widx in self.device_shards():
            starts = torch.from_numpy(widx.astype(np.int64)).to(self.device)
            for b in range(self._n_batches(len(widx))):
                idx = starts[b * self.batch:(b + 1) * self.batch]
                yield (gather_windows(frames, idx, self.frame_skip, self.dtype),
                       actions[idx + self.frame_skip])

    def __len__(self) -> int:
        total = 0
        for p in self._shard_paths():
            with NativeFrameStore(p) as nfs:
                total += self._n_batches(
                    len(valid_window_starts(nfs.n, nfs.starts, self.frame_skip)))
        return total


class ShardedPrefetchReader:
    """Two-level shuffled window-batch iterator over a shard directory:
    shards in a ``default_rng(seed + epoch)`` order, windows by the C++
    reader inside each. Yields ``PrefetchReader``'s (frames uint8 (B, fs,
    H, W), labels int32 (B,)); one shard is mapped at a time."""

    def __init__(self, store: ShardedFrameStore, batch: int,
                 frame_skip: int = 4, n_threads: int = 4,
                 shuffle: bool = True, seed: int = 0, max_queue: int = 4):
        self.store = store
        self.batch = batch
        self.frame_skip = frame_skip
        self.n_threads = n_threads
        self.shuffle = shuffle
        self.seed = seed
        self.max_queue = max_queue
        self._epoch = 0

    def __len__(self) -> int:
        total = 0
        for i in range(self.store.n_shards):
            if self.store.shard_frames(i) <= self.frame_skip:
                continue
            with self.store.open_shard(i) as nfs:
                v = nfs.n_valid_windows(self.frame_skip)
            if v > 0:
                total += max(1, v // self.batch)
        return total

    def __iter__(self):
        order = np.arange(self.store.n_shards)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        for si in order:
            if self.store.shard_frames(int(si)) <= self.frame_skip:
                continue  # shard too small for one window
            with self.store.open_shard(int(si)) as nfs:
                if nfs.n_valid_windows(self.frame_skip) == 0:
                    continue  # every window would cross an episode start
                reader = PrefetchReader(
                    nfs, batch=self.batch, frame_skip=self.frame_skip,
                    n_threads=self.n_threads, shuffle=self.shuffle,
                    seed=self.seed + 1000 * self._epoch + int(si),
                    max_queue=self.max_queue)
                yield from reader

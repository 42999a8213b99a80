"""The CARLA frame-log file contract and synthetic logs (the JAX package's
``data/frame_log.py``, in numpy as there).

- ``<data_dir>/raw/<Log>/<camera>/*.png|jpeg``: camera frames named by
  1-based integers (``file_idx = int(stem) - 1``);
- ``<data_dir>/raw/state.csv`` (or ``raw/<Log>/state.csv``): the autopilot
  log, one row per frame, columns ``steer, throttle, brake, trafficlight,
  current_steer, speed_long, speed`` (``StateLog``);
- ``<data_dir>/processed/<Log>/<split>/<Log>/*.png``: the sequential
  80/10/10 split folders of ``split_frames``.

Both packages write the same bytes (state.csv through ``np.savetxt`` with
``%.6g``; PNG through PIL) and read each other's files.
``make_synthetic_state`` and ``synthetic_frames`` draw the same procedural
log as the JAX package from the same seed. state.csv is parsed with the
standard library's ``csv`` and ``float``, which rounds correctly.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import shutil
from pathlib import Path
from typing import Sequence

import numpy as np

STATE_COLUMNS = (
    "steer", "throttle", "brake", "trafficlight", "current_steer", "speed_long", "speed",
)

LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float64)


@dataclasses.dataclass
class StateLog:
    """Columnar autopilot state (one row per frame)."""

    steer: np.ndarray
    throttle: np.ndarray
    brake: np.ndarray
    trafficlight: np.ndarray
    current_steer: np.ndarray
    speed_long: np.ndarray
    speed: np.ndarray

    def __len__(self) -> int:
        return len(self.steer)

    @property
    def sensors(self) -> np.ndarray:
        """(N, 3) float32 sensor vector ``(current_steer, speed_long, speed)``."""
        return np.stack(
            [self.current_steer, self.speed_long, self.speed], axis=-1
        ).astype(np.float32)


def load_state_csv(path: str | os.PathLike) -> StateLog:
    """Read state.csv by column name; every column as float64."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header = rows[0] if rows else []
    missing = [c for c in STATE_COLUMNS if c not in header]
    if missing:
        raise ValueError(f"state.csv {path} missing columns {missing}")
    data = np.array([[float(v) for v in r] for r in rows[1:]],
                    dtype=np.float64).reshape(-1, len(header))
    return StateLog(**{c: data[:, header.index(c)] for c in STATE_COLUMNS})


def save_state_csv(path: str | os.PathLike, state: StateLog) -> None:
    arr = np.stack([getattr(state, c) for c in STATE_COLUMNS], axis=-1)
    header = ",".join(STATE_COLUMNS)
    np.savetxt(path, arr, delimiter=",", header=header, comments="", fmt="%.6g")


def _numeric_sorted(names: Sequence[str]) -> list[str]:
    """Frame file names sorted by their integer stem."""
    return sorted(names, key=lambda n: int(os.path.splitext(n)[0]))


def _to_gray_u8(img: np.ndarray) -> np.ndarray:
    """HxW or HxWx3(4) uint8 → HxW uint8 luminance, rounded in float64."""
    if img.ndim == 3:
        img = np.round(img[..., :3] @ LUMA)
    return img.astype(np.uint8)


class FrameLog:
    """A directory of numerically named frames, decoded lazily."""

    def __init__(self, directory: str | os.PathLike):
        self.directory = Path(directory)
        names = [n for n in os.listdir(self.directory)
                 if os.path.splitext(n)[0].isdigit()]
        if not names:
            raise FileNotFoundError(f"no frames in {self.directory}")
        self.names = _numeric_sorted(names)
        # 1-based file names → 0-based state-row index
        self.file_idx = np.array([int(os.path.splitext(n)[0]) - 1 for n in self.names])

    def __len__(self) -> int:
        return len(self.names)

    def read(self, i: int) -> np.ndarray:
        """Decode frame i → HxW or HxWx3 uint8."""
        from PIL import Image

        with Image.open(self.directory / self.names[i]) as im:
            return np.asarray(im)

    def read_gray_f32(self, i: int) -> np.ndarray:
        """Luminance grayscale in [0, 1]."""
        img = self.read(i)
        if img.ndim == 3:
            img = img[..., :3] @ LUMA
        return (img / 255.0).astype(np.float32)

    def read_all_gray_u8(self) -> np.ndarray:
        """(N, H, W) uint8 luminance, the packed form of a ``FrameStore``."""
        first = _to_gray_u8(self.read(0))
        out = np.empty((len(self),) + first.shape, dtype=np.uint8)
        out[0] = first
        for i in range(1, len(self)):
            out[i] = _to_gray_u8(self.read(i))
        return out


def save_frames(
    directory: str | os.PathLike,
    frames: np.ndarray,
    start_index: int = 1,
    image_format: str = "png",
    workers: int | None = None,
    compress_level: int = 1,
) -> int:
    """Write (N, H, W[, 3]) uint8 frames as 1-based numbered files.

    PNG at ``compress_level`` 1 (lossless, as every level is), encoded on a
    thread pool of ``workers`` threads (default min(8, cpu_count); zlib and
    libjpeg release the GIL). Returns N."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    frames = np.ascontiguousarray(frames)
    kwargs = {"compress_level": int(compress_level)} if image_format == "png" else {}

    def write_one(i: int) -> None:
        Image.fromarray(frames[i]).save(
            directory / f"{i + start_index}.{image_format}", **kwargs)

    if workers <= 1 or len(frames) < 4:
        for i in range(len(frames)):
            write_one(i)
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(write_one, range(len(frames))))
    return len(frames)


def split_frames(
    read_path: str | os.PathLike,
    output: str | os.PathLike,
    ratio: tuple[float, float, float] = (0.8, 0.1, 0.1),
    shuffle: bool = False,
    seed: int = 1337,
    use_hardlinks: bool = True,
) -> dict[str, int]:
    """Split every frame subfolder of ``read_path`` into train/val/test
    folders under ``output``, keeping the subfolder names (``raw/Log1/cam``
    → ``processed/Log1/train/cam``). Sequential unless ``shuffle``, so frame
    windows stay contiguous in time. Files are hard-linked where the file
    system allows, else copied."""
    read_path, output = Path(read_path), Path(output)
    rng = np.random.default_rng(seed)
    counts = {"train": 0, "val": 0, "test": 0}
    for sub in sorted(p for p in read_path.iterdir() if p.is_dir()):
        names = [n for n in os.listdir(sub) if os.path.splitext(n)[0].isdigit()]
        if not names:
            continue
        names = _numeric_sorted(names)
        if shuffle:
            rng.shuffle(names)
        n = len(names)
        n_train = int(ratio[0] * n)
        n_val = int(ratio[1] * n)
        splits = {
            "train": names[:n_train],
            "val": names[n_train:n_train + n_val],
            "test": names[n_train + n_val:],
        }
        for split, files in splits.items():
            dst_dir = output / split / sub.name
            dst_dir.mkdir(parents=True, exist_ok=True)
            for name in files:
                src, dst = sub / name, dst_dir / name
                if dst.exists():
                    continue
                if use_hardlinks:
                    try:
                        os.link(src, dst)
                        continue
                    except OSError:
                        pass
                shutil.copy2(src, dst)
            counts[split] += len(files)
    return counts


def make_synthetic_state(n: int, seed: int = 0) -> StateLog:
    """Plausible autopilot state: piecewise maneuvers with CARLA-like control values."""
    rng = np.random.default_rng(seed)
    steer = np.zeros(n)
    throttle = np.zeros(n)
    brake = np.zeros(n)
    i = 0
    while i < n:
        seg = int(rng.integers(5, 20))
        mode = rng.integers(0, 4)
        if mode == 0:  # cruise full throttle
            throttle[i:i + seg], brake[i:i + seg] = 1.0, 0.0
        elif mode == 1:  # cruise half throttle
            throttle[i:i + seg], brake[i:i + seg] = 0.5, 0.0
        elif mode == 2:  # brake
            throttle[i:i + seg], brake[i:i + seg] = 0.0, 1.0
        else:  # turn while at full throttle
            throttle[i:i + seg], brake[i:i + seg] = 1.0, 0.0
            steer[i:i + seg] = rng.choice([-0.4, 0.4]) * rng.random(min(seg, n - i))
        i += seg
    trafficlight = (rng.random(n) < 0.15).astype(np.float64)
    speed = np.clip(np.cumsum(throttle - brake) * 0.1, 0, 12.0)
    return StateLog(
        steer=steer,
        throttle=throttle,
        brake=brake,
        trafficlight=trafficlight,
        current_steer=steer * 0.9 + rng.normal(0, 0.01, n),
        speed_long=speed * np.cos(steer),
        speed=speed,
    )


def synthetic_frames(n: int, height: int, width: int, seed: int = 0) -> np.ndarray:
    """(N, H, W, 3) uint8 procedural road-like frames with temporal coherence:
    a moving horizon, a road trapezoid that shifts with a latent steering
    signal, and textured noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    drift = np.cumsum(rng.normal(0, 1.5, n))
    ys = np.linspace(0, 1, height)[:, None]
    xs = np.linspace(-1, 1, width)[None, :]
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    for i in range(n):
        horizon = 0.45 + 0.05 * np.sin(t[i] / 17.0)
        sky = (ys < horizon).astype(np.float32)
        center = 0.4 * np.tanh(drift[i] / 50.0)
        half_w = 0.15 + 0.8 * np.clip(ys - horizon, 0, 1)
        road = ((np.abs(xs - center * (1 - ys)) < half_w) & (ys >= horizon)).astype(np.float32)
        r = 40 + 90 * sky + 50 * road
        g = 60 + 120 * sky + 45 * road
        b = 50 + 180 * sky + 55 * road
        noise = rng.normal(0, 6, (height, width))
        out[i] = np.clip(np.stack([r + noise, g + noise, b + noise], -1), 0, 255).astype(np.uint8)
    return out


def write_synthetic_log(
    data_dir: str | os.PathLike,
    log: str = "Log1",
    cameras: Sequence[str] = ("camera",),
    n_frames: int = 64,
    height: int = 256,
    width: int = 256,
    seed: int = 0,
    image_format: str = "png",
) -> StateLog:
    """Write a full synthetic raw log in the frame-log contract: state.csv
    under ``raw/`` and ``raw/<log>/``, and one frame folder per camera
    (camera ``i`` drawn with seed ``seed + 101 * i``)."""
    data_dir = Path(data_dir)
    state = make_synthetic_state(n_frames, seed)
    raw = data_dir / "raw"
    (raw / log).mkdir(parents=True, exist_ok=True)
    save_state_csv(raw / "state.csv", state)
    save_state_csv(raw / log / "state.csv", state)
    for c_i, camera in enumerate(cameras):
        frames = synthetic_frames(n_frames, height, width, seed + 101 * c_i)
        save_frames(raw / log / camera, frames, image_format=image_format)
    return state

"""Offline ETL (the JAX package's ``data/etl.py``): pack a camera folder
into one compressed array file, and resize a camera folder to the
``<camera>_resized_<size>_bw`` grayscale folders.

``compress_data`` writes npz by default; an ``.h5``/``.hdf5`` path is
written with h5py when it imports, else the npz beside it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from carla_imitation_learning_tpu_torch.data import frame_log as fl


def compress_data(cfg, log: str | None = None, camera: str | None = None,
                  out_path: str | None = None) -> Path:
    """Pack ``raw/<log>/<camera>/`` as uint8 luminance frames (with their
    ``file_idx`` in the npz form)."""
    log = log or cfg["train_logs"][0]
    camera = camera or (cfg["camera"] if isinstance(cfg["camera"], str)
                        else cfg["camera"][0])
    data_dir = Path(cfg["data_dir"])
    flog = fl.FrameLog(data_dir / "raw" / log / camera)
    frames = flog.read_all_gray_u8()
    out = Path(out_path) if out_path else data_dir / "processed" / f"{log}_{camera}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.suffix in (".h5", ".hdf5"):
        try:
            import h5py
        except ImportError:
            out = out.with_suffix(".npz")
        else:
            with h5py.File(out, "w") as f:
                f.create_dataset("images", data=frames, compression="gzip")
            return out
    np.savez_compressed(out, images=frames, file_idx=flog.file_idx)
    return out


def load_compressed(path: str | Path) -> np.ndarray:
    path = Path(path)
    if path.suffix in (".h5", ".hdf5"):
        import h5py

        with h5py.File(path, "r") as f:
            return np.asarray(f["images"])
    return np.load(path)["images"]


def resize_camera_folder(cfg, log: str, camera: str, size: int = 224) -> Path:
    """Write ``raw/<log>/<camera>_resized_<size>_bw/``: grayscale
    size×size PNGs (PIL bilinear) of every frame."""
    from PIL import Image

    data_dir = Path(cfg["data_dir"])
    src = fl.FrameLog(data_dir / "raw" / log / camera)
    dst = data_dir / "raw" / log / f"{camera}_resized_{size}_bw"
    dst.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(src.names):
        img = src.read(i)
        if img.ndim == 3:
            img = np.round(img[..., :3] @ fl.LUMA).astype(np.uint8)
        im = Image.fromarray(img).resize((size, size), Image.BILINEAR)
        im.save(dst / f"{Path(name).stem}.png")
    return dst

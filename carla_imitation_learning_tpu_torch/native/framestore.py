"""ctypes bindings for ``framestore.cpp``, this package's copy of the packed
frame store, built with g++ at first use.

The library is compiled into ``<package>/build/`` (git-ignored), named by a
hash of its source and flags, so an edited source is rebuilt and an
unchanged one reused; a build that fails raises. Nothing is built when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from carla_imitation_learning_tpu_torch.data.pipeline import FrameStore, valid_window_starts

SRC = Path(__file__).resolve().with_name("framestore.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
TSAN_FLAGS = ("-fsanitize=thread", "-g", "-O1", "-std=c++17", "-pthread",
              "-DFS_TEST_MAIN")

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: it is needed to build the frame store")
    return path


def _compile(flags, out: Path) -> Path:
    """Compile ``SRC`` with ``flags`` into ``out`` unless it exists; the
    output appears atomically, so a concurrent build never loads half a
    file."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.partial")
    proc = subprocess.run([_cxx(), *flags, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC}:\n{proc.stdout}{proc.stderr}")
    tmp.replace(out)
    return out


def _output(flags, stem: str, suffix: str) -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}{suffix}"


def build_library() -> Path:
    """The shared library, compiled on first use."""
    return _compile(CXX_FLAGS, _output(CXX_FLAGS, "libframestore", ".so"))


def build_tsan_test() -> Path:
    """The ThreadSanitizer self-test executable (``FS_TEST_MAIN``); run it
    with a scratch file path as its one argument."""
    return _compile(TSAN_FLAGS, _output(TSAN_FLAGS, "fs_tsan_test", ""))


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.fs_write.restype = ctypes.c_int
        lib.fs_write.argtypes = [ctypes.c_char_p] + [ptr] * 6 + [i64] * 3
        lib.fs_open.restype = ptr
        lib.fs_open.argtypes = [ctypes.c_char_p]
        lib.fs_info.restype = None
        lib.fs_info.argtypes = [ptr] + [ctypes.POINTER(i64)] * 3
        for name in ("fs_frames", "fs_actions", "fs_traffic", "fs_sensors",
                     "fs_commands", "fs_starts"):
            getattr(lib, name).restype = ptr
            getattr(lib, name).argtypes = [ptr]
        lib.fs_close.restype = None
        lib.fs_close.argtypes = [ptr]
        lib.fs_reader_create.restype = ptr
        lib.fs_reader_create.argtypes = [
            ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int]
        lib.fs_reader_n_batches.restype = i64
        lib.fs_reader_n_batches.argtypes = [ptr]
        lib.fs_reader_next.restype = ctypes.c_int
        lib.fs_reader_next.argtypes = [ptr, ptr, ptr]
        lib.fs_reader_destroy.restype = None
        lib.fs_reader_destroy.argtypes = [ptr]
        _lib = lib
        return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def save_framestore(path: str | os.PathLike, store) -> Path:
    """Write a ``FrameStore`` in the packed v2 format (``TPUILFS2``), with
    the episode-start bitmap, so the reader never samples a window across an
    episode start. Commands and starts default to zeros."""
    lib = _load()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    frames = np.ascontiguousarray(store.frames, dtype=np.uint8)
    if frames.ndim != 3:
        raise ValueError(f"frames must be (N, H, W), got {frames.shape}")
    n, h, w = frames.shape
    columns = []
    for a, dtype, shape in (
            (store.actions, np.int32, (n,)), (store.traffic, np.int32, (n,)),
            (store.sensors, np.float32, (n, 3)),
            (store.commands if store.commands is not None else np.zeros(n), np.int32, (n,)),
            (store.starts if store.starts is not None else np.zeros(n), np.uint8, (n,))):
        columns.append(np.ascontiguousarray(a, dtype=dtype))
        if columns[-1].shape != shape:
            raise ValueError(f"a column of shape {columns[-1].shape} for {n} frames")
    rc = lib.fs_write(str(path).encode(), _ptr(frames), *map(_ptr, columns), n, h, w)
    if rc != 0:
        raise OSError(f"fs_write failed with code {rc} for {path}")
    return path


class NativeFrameStore:
    """mmap-backed zero-copy view of a packed frame-store file (v1 or v2)."""

    def __init__(self, path: str | os.PathLike):
        self._lib = _load()
        self._handle = self._lib.fs_open(str(path).encode())
        if not self._handle:
            raise OSError(f"cannot open framestore {path}")
        n, h, w = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        self._lib.fs_info(self._handle, ctypes.byref(n), ctypes.byref(h), ctypes.byref(w))
        self.n, self.h, self.w = n.value, h.value, w.value

    def _view(self, fn, dtype, shape) -> np.ndarray:
        ptr = fn(self._handle)
        size = int(np.prod(shape)) * np.dtype(dtype).itemsize
        buf = (ctypes.c_char * size).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    @property
    def frames(self) -> np.ndarray:
        return self._view(self._lib.fs_frames, np.uint8, (self.n, self.h, self.w))

    @property
    def actions(self) -> np.ndarray:
        return self._view(self._lib.fs_actions, np.int32, (self.n,))

    @property
    def traffic(self) -> np.ndarray:
        return self._view(self._lib.fs_traffic, np.int32, (self.n,))

    @property
    def sensors(self) -> np.ndarray:
        return self._view(self._lib.fs_sensors, np.float32, (self.n, 3))

    @property
    def commands(self) -> np.ndarray:
        return self._view(self._lib.fs_commands, np.int32, (self.n,))

    @property
    def starts(self) -> np.ndarray | None:
        """Episode-start bitmap (bool); None for v1 (``TPUILFS1``) files."""
        if not self._lib.fs_starts(self._handle):
            return None
        return self._view(self._lib.fs_starts, np.uint8, (self.n,)).astype(bool)

    def n_valid_windows(self, frame_skip: int) -> int:
        """Window starts the reader samples (none crosses an episode start)."""
        if self.n - frame_skip <= 0:
            return 0
        return len(valid_window_starts(self.n, self.starts, frame_skip))

    def to_frame_store(self) -> FrameStore:
        return FrameStore(frames=self.frames, actions=self.actions,
                          traffic=self.traffic, sensors=self.sensors,
                          commands=self.commands, starts=self.starts)

    def close(self) -> None:
        if self._handle:
            self._lib.fs_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeFrameStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


class PrefetchReader:
    """Threaded window-batch iterator over a ``NativeFrameStore``.

    Yields ``(frames uint8 (B, frame_skip, H, W), labels int32 (B,))`` in
    batch-index order whatever ``n_threads``: window k is
    ``frames[k:k + frame_skip]`` with label ``actions[k + frame_skip]``, in
    order or shuffled by the C++ reader's ``std::mt19937_64(seed)``.
    Normalise on the device."""

    def __init__(self, store: NativeFrameStore, batch: int, frame_skip: int = 4,
                 n_threads: int = 4, shuffle: bool = False, seed: int = 0,
                 max_queue: int = 4):
        self._store = store
        self._lib = store._lib
        self.batch = batch
        self.frame_skip = frame_skip
        self._args = (int(batch), int(frame_skip), int(n_threads), int(shuffle),
                      int(seed), int(max_queue))

    def __iter__(self):
        lib = self._lib
        reader = lib.fs_reader_create(self._store._handle, *self._args)
        if not reader:
            raise RuntimeError("fs_reader_create failed (store too small?)")
        try:
            frames = np.empty((self.batch, self.frame_skip, self._store.h, self._store.w),
                              np.uint8)
            labels = np.empty((self.batch,), np.int32)
            for _ in range(lib.fs_reader_n_batches(reader)):
                if lib.fs_reader_next(reader, _ptr(frames), _ptr(labels)) != 0:
                    break
                yield frames.copy(), labels.copy()
        finally:
            lib.fs_reader_destroy(reader)

    def __len__(self) -> int:
        return max(1, self._store.n_valid_windows(self.frame_skip) // self.batch)

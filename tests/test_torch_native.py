"""The port's copy of the packed frame store against the JAX package's:
byte-identical files read by either package, v1 files, refused garbage, a
reader that hands batches out in index order for 1 to 4 threads, the JAX
reader's multiset per shuffled epoch, and a ThreadSanitizer-clean build."""

import fcntl
import subprocess

import numpy as np
import pytest

from carla_imitation_learning_tpu.data.pipeline import FrameStore as JStore
from carla_imitation_learning_tpu.native import NativeFrameStore as JNative
from carla_imitation_learning_tpu.native import PrefetchReader as JReader
from carla_imitation_learning_tpu.native import save_framestore as j_save
from carla_imitation_learning_tpu_torch.data.pipeline import FrameStore, valid_window_starts
from carla_imitation_learning_tpu_torch.native import framestore as p_native
from carla_imitation_learning_tpu_torch.native import (
    NativeFrameStore, PrefetchReader, save_framestore,
)

N, HW, FS = 230, 12, 4


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package's frame-store library, built once under a file lock:
    its ``build_library`` compiles in place, so test workers must not build it at the
    same time."""
    from carla_imitation_learning_tpu.native import framestore as j_fs

    j_fs._LIB_DIR.mkdir(parents=True, exist_ok=True)
    with open(j_fs._LIB_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        assert j_fs.build_library() is not None, "g++ build of the JAX library failed"


def _store(pkg_store=FrameStore, n=N, seed=0, starts=True):
    """Frames whose first pixel is the frame index (mod 256), random labels,
    episode starts every 37 frames."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, HW, HW), dtype=np.uint8)
    frames[:, 0, 0] = np.arange(n) % 256
    st = None
    if starts:
        st = np.zeros(n, bool)
        st[::37] = True
    return pkg_store(frames=frames, actions=rng.integers(0, 9, n).astype(np.int32),
                     traffic=rng.integers(0, 2, n).astype(np.int32),
                     sensors=rng.normal(size=(n, 3)).astype(np.float32),
                     commands=rng.integers(0, 6, n).astype(np.int32), starts=st)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("fs")
    store = _store()
    save_framestore(root / "port.tpuilfs", store)
    j_save(root / "jax.tpuilfs", _store(JStore))
    return root, store


def test_files_are_byte_identical(files):
    root, _ = files
    assert (root / "port.tpuilfs").read_bytes() == (root / "jax.tpuilfs").read_bytes()
    header = np.frombuffer((root / "port.tpuilfs").read_bytes()[:32], np.int64)
    assert header.tolist() == [0x3253464C49555054, N, HW, HW]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_reads_the_other(files, writer, reader):
    root, store = files
    nfs = (NativeFrameStore if reader == "port" else JNative)(root / f"{writer}.tpuilfs")
    try:
        assert (nfs.n, nfs.h, nfs.w) == (N, HW, HW)
        for f in ("frames", "actions", "traffic", "sensors", "commands", "starts"):
            np.testing.assert_array_equal(getattr(nfs, f), getattr(store, f), err_msg=f)
        assert nfs.n_valid_windows(FS) == len(valid_window_starts(N, store.starts, FS))
        back = nfs.to_frame_store()
        np.testing.assert_array_equal(back.frames, store.frames)
    finally:
        nfs.close()


def test_defaults_and_legacy_v1(tmp_path):
    """A store without commands or starts writes zeros (same bytes as the
    JAX writer); a v1 file opens with no starts, every window valid."""
    store = _store(starts=False)
    store.commands = None
    jstore = _store(JStore, starts=False)
    jstore.commands = None
    save_framestore(tmp_path / "p.tpuilfs", store)
    j_save(tmp_path / "j.tpuilfs", jstore)
    assert (tmp_path / "p.tpuilfs").read_bytes() == (tmp_path / "j.tpuilfs").read_bytes()
    v1 = tmp_path / "v1.tpuilfs"
    with open(v1, "wb") as f:
        f.write(np.array([0x3153464C49555054, N, HW, HW], np.int64).tobytes())
        for a, dt in ((store.frames, np.uint8), (store.actions, np.int32),
                      (store.traffic, np.int32), (store.sensors, np.float32),
                      (np.zeros(N), np.int32)):
            f.write(np.ascontiguousarray(a, dt).tobytes())
    with NativeFrameStore(v1) as nfs:
        assert nfs.starts is None
        assert nfs.n_valid_windows(FS) == N - FS
        np.testing.assert_array_equal(nfs.frames, store.frames)
        labels = np.concatenate([lab for _, lab in PrefetchReader(nfs, 8, FS, n_threads=3)])
        np.testing.assert_array_equal(labels, store.actions[FS:FS + len(labels)])


@pytest.mark.parametrize("content", [b"not a framestore at all", b""])
def test_garbage_is_refused(tmp_path, content):
    bad = tmp_path / "bad.tpuilfs"
    bad.write_bytes(content)
    with pytest.raises(OSError):
        NativeFrameStore(bad)


def test_truncated_file_is_refused(files, tmp_path):
    root, _ = files
    cut = tmp_path / "cut.tpuilfs"
    cut.write_bytes((root / "port.tpuilfs").read_bytes()[:-1])
    with pytest.raises(OSError):
        NativeFrameStore(cut)


def _epoch(reader):
    return [(f.copy(), lab.copy()) for f, lab in reader]


@pytest.mark.parametrize("shuffle", [False, True])
def test_reader_keeps_batch_order_for_any_thread_count(files, shuffle):
    """1 to 4 threads, a queue of 1 or 4: the same batches in the same order
    as the JAX reader's single thread (the same ``std::mt19937_64``
    shuffle); without shuffling, window k is frames[k:k+4] of the valid
    starts with label actions[k+4]."""
    root, store = files
    jnfs = JNative(root / "jax.tpuilfs")
    want = _epoch(JReader(jnfs, 8, FS, n_threads=1, shuffle=shuffle, seed=11))
    jnfs.close()
    with NativeFrameStore(root / "port.tpuilfs") as nfs:
        for threads in (1, 2, 3, 4):
            for queue in (1, 4):
                got = _epoch(PrefetchReader(nfs, 8, FS, n_threads=threads, shuffle=shuffle,
                                            seed=11, max_queue=queue))
                assert len(got) == len(want) == len(valid_window_starts(
                    N, store.starts, FS)) // 8
                for (gf, gl), (wf, wl) in zip(got, want):
                    np.testing.assert_array_equal(gf, wf)
                    np.testing.assert_array_equal(gl, wl)
    if not shuffle:
        starts = valid_window_starts(N, store.starts, FS)
        flat = np.concatenate([f for f, _ in got])
        for i, k in enumerate(starts[:len(flat)]):
            np.testing.assert_array_equal(flat[i], store.frames[k:k + FS])
        np.testing.assert_array_equal(np.concatenate([lab for _, lab in got]),
                                      store.actions[starts[:len(flat)] + FS])


def test_shuffled_epoch_is_the_jax_readers_multiset(files):
    """A shuffled epoch holds the same windows as the JAX reader's with 4
    threads (whose batch order may differ), each window a valid start."""
    root, store = files
    jnfs = JNative(root / "jax.tpuilfs")
    jax_windows = sorted(int(f[i, 0, 0, 0]) for f, _ in
                         JReader(jnfs, 4, FS, n_threads=4, shuffle=True, seed=3)
                         for i in range(4))
    jnfs.close()
    with NativeFrameStore(root / "port.tpuilfs") as nfs:
        port_windows = sorted(int(f[i, 0, 0, 0]) for f, _ in
                              PrefetchReader(nfs, 4, FS, n_threads=4, shuffle=True, seed=3)
                              for i in range(4))
    assert port_windows == jax_windows
    valid = set((valid_window_starts(N, store.starts, FS) % 256).tolist())
    assert set(port_windows) <= valid


def test_reader_stopped_mid_epoch_joins(files):
    """Closing the generator after two batches destroys the reader while
    its workers wait for their turn; the next epoch starts afresh."""
    root, _ = files
    with NativeFrameStore(root / "port.tpuilfs") as nfs:
        reader = PrefetchReader(nfs, 4, FS, n_threads=4, shuffle=True, seed=1, max_queue=2)
        for _ in range(5):
            it = iter(reader)
            first = [next(it), next(it)]
            it.close()
        assert len(_epoch(reader)) == len(reader)
        np.testing.assert_array_equal(first[0][0], next(iter(reader))[0])


def test_too_small_store_raises(tmp_path):
    save_framestore(tmp_path / "tiny.tpuilfs", _store(n=FS))
    with NativeFrameStore(tmp_path / "tiny.tpuilfs") as nfs:
        with pytest.raises(RuntimeError, match="fs_reader_create"):
            next(iter(PrefetchReader(nfs, 2, FS)))


def test_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; no writer stands in."""
    bad = tmp_path / "framestore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(p_native, "SRC", bad)
    monkeypatch.setattr(p_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        p_native.build_library()


def test_thread_sanitizer_clean(tmp_path):
    """The self-test (every thread count gives the 1-thread sequence;
    readers destroyed mid-epoch) runs clean under ThreadSanitizer."""
    exe = p_native.build_tsan_test()
    run = subprocess.run([str(exe), str(tmp_path / "tsan.tpuilfs")], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, (run.stdout, run.stderr)
    assert "ThreadSanitizer" not in run.stderr, run.stderr

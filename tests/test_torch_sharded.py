"""Sharded frame stores and ``device_prefetch`` of the port against the JAX
package's: cut points, manifests and shard files byte for byte, the shard
order and window streams of both readers, correct windows and labels from
the streamer, and ``device_prefetch`` keeping order and content."""

import fcntl
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu.native import sharded as j_sh
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe
from carla_imitation_learning_tpu_torch.data.pipeline import valid_window_starts
from carla_imitation_learning_tpu_torch.native import sharded as p_sh

FS = 4


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


def _identity_store(pipe, n=300, hw=8, episode_len=60):
    """Frames whose pixels hold the frame index (mod 252), labels index % 9."""
    frames = np.broadcast_to((np.arange(n) % 252).astype(np.uint8)[:, None, None],
                             (n, hw, hw)).copy()
    starts = np.zeros(n, bool)
    starts[::episode_len] = True
    return pipe.FrameStore(frames=frames, actions=(np.arange(n) % 9).astype(np.int32),
                           traffic=np.zeros(n, np.int32), sensors=np.zeros((n, 3), np.float32),
                           commands=np.zeros(n, np.int32), starts=starts)


@pytest.mark.parametrize("n,starts_every,target", [
    (300, 60, 100), (250, None, 100), (80, 60, 100), (300, 300, 100), (1000, 7, 96),
    (97, 1, 10)])
def test_cut_points_match(n, starts_every, target):
    starts = None
    if starts_every is not None:
        starts = np.zeros(n, bool)
        starts[::starts_every] = True
    assert p_sh._cut_points(n, starts, target) == j_sh._cut_points(n, starts, target)


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    p_sh.save_sharded_framestore(root / "port", _identity_store(p_pipe), shard_frames=100)
    j_sh.save_sharded_framestore(root / "jax", _identity_store(j_pipe), shard_frames=100)
    return root


def test_manifest_and_shards_are_identical(shard_dirs):
    port, jax_ = shard_dirs / "port", shard_dirs / "jax"
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in jax_.iterdir())
    for name in names:
        assert (port / name).read_bytes() == (jax_ / name).read_bytes(), name
    manifest = json.loads((port / p_sh.INDEX_NAME).read_text())
    assert [s["n"] for s in manifest["shards"]] == [60, 60, 60, 60, 60]
    assert manifest["aligned_to_starts"]
    store = p_sh.ShardedFrameStore(jax_)
    assert (store.n_shards, store.n_frames, store.height) == (5, 300, 8)
    with store.open_shard(2) as nfs:
        assert int(nfs.frames[0, 0, 0]) == 120 and nfs.starts[0]


def _batches(reader, epochs):
    return [[(np.asarray(f), np.asarray(lab)) for f, lab in reader] for _ in range(epochs)]


def test_sharded_reader_streams_match_jax(shard_dirs):
    """Two epochs: the same shard order (``default_rng(seed + epoch)``) and
    per-shard window order (seed ``seed + 1000 * epoch + shard``) as the
    JAX reader run with one thread; the port's uses four."""
    port = p_sh.ShardedPrefetchReader(p_sh.ShardedFrameStore(shard_dirs / "port"), batch=8,
                                      frame_skip=FS, n_threads=4, seed=7)
    jax_ = j_sh.ShardedPrefetchReader(j_sh.ShardedFrameStore(shard_dirs / "jax"), batch=8,
                                      frame_skip=FS, n_threads=1, seed=7)
    assert len(port) == len(jax_) == 5 * (56 // 8)
    for pe, je in zip(_batches(port, 2), _batches(jax_, 2)):
        assert len(pe) == len(je) == len(port)
        for (pf, pl), (jf, jl) in zip(pe, je):
            np.testing.assert_array_equal(pf, jf)
            np.testing.assert_array_equal(pl, jl)


@pytest.mark.parametrize("shuffle", [True, False])
def test_streamer_matches_jax(shard_dirs, shuffle):
    """``DeviceShardStreamer`` on the CPU: per epoch the JAX streamer's
    batches, bit for bit (labels as int64)."""
    port = p_sh.DeviceShardStreamer(shard_dirs / "port", batch=8, frame_skip=FS, seed=3,
                                    shuffle=shuffle, device="cpu")
    jax_ = j_sh.DeviceShardStreamer(shard_dirs / "jax", batch=8, frame_skip=FS, seed=3,
                                    shuffle=shuffle)
    assert len(port) == len(jax_)
    for pe, je in zip(_batches(port, 2), _batches(jax_, 2)):
        assert len(pe) == len(je) == len(port)
        for (px, py), (jx, jy) in zip(pe, je):
            np.testing.assert_array_equal(px, jx)
            np.testing.assert_array_equal(py, jy.astype(np.int64))


def test_streamer_windows_and_labels(shard_dirs):
    """Every window is four consecutive frames of one episode, labelled by
    the frame after it; with ``drop_last=False`` one epoch covers each
    valid window exactly once; a single file is one shard."""
    store = _identity_store(p_pipe)
    streamer = p_sh.DeviceShardStreamer(shard_dirs / "port", batch=8, frame_skip=FS,
                                        device="cpu", drop_last=False)
    starts = []
    for x, y in streamer:
        assert x.shape[1:] == (8, 8, FS) and x.dtype == torch.float32
        first = torch.round(x[:, 0, 0, 0] * 255).to(torch.int64).numpy()
        for t in range(FS):
            np.testing.assert_array_equal(torch.round(x[:, 0, 0, t] * 255).numpy(),
                                          (first + t) % 252)
        np.testing.assert_array_equal(y.numpy(), (first + FS) % 9)
        starts += first.tolist()
    assert sorted(starts) == sorted((valid_window_starts(300, store.starts, FS) % 252).tolist())
    single = shard_dirs / "single.tpuilfs"
    p_sh.save_framestore(single, store)
    assert len(p_sh.DeviceShardStreamer(single, batch=8, frame_skip=FS, device="cpu")) \
        == len(valid_window_starts(300, store.starts, FS)) // 8


def test_device_prefetch_keeps_order_and_content():
    """Order and content kept for any lead; ``transform`` runs before the
    copy; the JAX package's ``device_prefetch`` gives the same values."""
    batches = [(np.full((2, 3), i, np.uint8), np.full((2,), i, np.int32)) for i in range(7)]
    for size in (1, 2, 3, 9):
        out = list(p_pipe.device_prefetch(iter(batches), size=size, device="cpu"))
        assert len(out) == 7
        for i, (f, lab) in enumerate(out):
            assert isinstance(f, torch.Tensor) and f.dtype == torch.uint8
            assert int(f[0, 0]) == i and int(lab[0]) == i and f.shape == (2, 3)
    tf = lambda b: (b[0].T, b[1] + 1)  # noqa: E731
    port = list(p_pipe.device_prefetch(iter(batches), size=2, transform=tf, device="cpu"))
    jax_ = list(j_pipe.device_prefetch(iter(batches), size=2, transform=tf))
    for (pf, pl), (jf, jl) in zip(port, jax_):
        np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    assert isinstance(jax_[0][0], jnp.ndarray)


def test_streaming_entry_points_refuse_missing_card(shard_dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_sh.DeviceShardStreamer(shard_dirs / "port", batch=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(p_pipe.device_prefetch(iter([(np.zeros(2),)])))

"""The data path: ``FrameStore``, ``valid_window_starts`` and
``DeviceDataset`` of the port against the JAX package's on the same
stores. Batches must agree bit for bit (uint8 frames normalised by the same
multiply), window orders exactly (the same numpy generator calls)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.data import frame_log as j_fl
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu_torch.data import frame_log as p_fl
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe

FIELDS = ("frames", "actions", "traffic", "sensors", "commands", "starts",
          "file_idx", "controls")


def _stores(n=48, seed=0):
    """The same synthetic store in each package, with episode starts,
    commands and controls set."""
    rng = np.random.default_rng(seed + 100)
    starts = rng.random(n) < 0.1
    starts[0] = True
    extra = {"starts": starts, "commands": rng.integers(0, 4, n).astype(np.int32),
             "controls": rng.normal(size=(n, 2)).astype(np.float32)}
    out = []
    for pipe in (j_pipe, p_pipe):
        s = pipe.FrameStore.synthetic(n, 64, 64, seed=seed)
        for k, v in extra.items():
            setattr(s, k, v.copy())
        out.append(s)
    return out


def _assert_store_equal(p, j):
    for f in FIELDS:
        a, b = getattr(p, f), getattr(j, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f


def test_synthetic_log_matches():
    for a, b in ((p_fl.make_synthetic_state(50, 3), j_fl.make_synthetic_state(50, 3)),):
        for col in p_fl.STATE_COLUMNS:
            np.testing.assert_array_equal(getattr(a, col), getattr(b, col), err_msg=col)
        np.testing.assert_array_equal(a.sensors, b.sensors)
    np.testing.assert_array_equal(p_fl.synthetic_frames(5, 32, 48, 2),
                                  j_fl.synthetic_frames(5, 32, 48, 2))
    np.testing.assert_array_equal(p_fl.LUMA, j_fl.LUMA)


def test_from_arrays_matches():
    state = j_fl.make_synthetic_state(30, seed=4)
    frames = np.random.default_rng(1).integers(0, 256, (30, 16, 16), dtype=np.uint8)
    file_idx = np.arange(2, 28)
    starts = np.zeros(26, bool)
    starts[[0, 9]] = True
    pstate = p_fl.StateLog(**{c: getattr(state, c) for c in p_fl.STATE_COLUMNS})
    _assert_store_equal(
        p_pipe.FrameStore.from_arrays(frames[file_idx], pstate, file_idx, starts),
        j_pipe.FrameStore.from_arrays(frames[file_idx], state, file_idx, starts))


@pytest.mark.parametrize("start,stop", [(0, 48), (5, 30), (17, 18), (40, 40)])
def test_slice_matches(start, stop):
    p, j = _stores()
    _assert_store_equal(p.slice(start, stop), j.slice(start, stop))


def test_concat_matches():
    p, j = _stores()
    p2, j2 = _stores(n=20, seed=3)
    p2.starts = j2.starts = None
    p2.commands = j2.commands = None
    _assert_store_equal(p_pipe.FrameStore.concat([p, p2, p.slice(3, 11)]),
                        j_pipe.FrameStore.concat([j, j2, j.slice(3, 11)]))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("span", [0, 3, 4, 6])
def test_valid_window_starts_matches(seed, span):
    rng = np.random.default_rng(seed)
    n = 40
    starts = rng.random(n) < (0.05 + 0.1 * seed)
    for st in (starts, None):
        got = p_pipe.valid_window_starts(n, st, span)
        want = j_pipe.valid_window_starts(n, st, span)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(p_pipe.valid_window_starts(n, starts, span, n_starts=17),
                                  j_pipe.valid_window_starts(n, starts, span, n_starts=17))


def test_gather_windows_matches():
    frames = np.random.default_rng(0).integers(0, 256, (20, 8, 12), dtype=np.uint8)
    idx = np.array([0, 3, 16, 7, 7])
    for dtype in ("float32", "bfloat16"):
        got = p_pipe.gather_windows(torch.from_numpy(frames), torch.from_numpy(idx), 4,
                                    getattr(torch, dtype))
        want = j_pipe.gather_windows(jnp.asarray(frames), jnp.asarray(idx), 4, dtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


CASES = {
    "plain": {},
    "shuffle": {"shuffle": True, "seed": 5},
    "balanced_action": {"balanced": True, "seed": 2},
    "balanced_command": {"balanced": True, "balance_key": "command", "seed": 2},
    "balanced_action_command": {"balanced": True, "balance_key": "action_command",
                                "seed": 2},
    "sample_mask": {"sample_mask": np.arange(48) % 3 != 1, "shuffle": True, "seed": 1},
    "label_offset_0": {"label_offset": 0},
    "partial_batch": {"drop_last": False, "shuffle": True, "seed": 9},
}


@pytest.mark.parametrize("case", CASES)
def test_device_dataset_matches(case):
    p_store, j_store = _stores()
    kw = CASES[case]
    p_ds = p_pipe.DeviceDataset(p_store, 8, device="cpu", **kw)
    j_ds = j_pipe.DeviceDataset(j_store, 8, **kw)
    assert len(p_ds) == len(j_ds) and p_ds.n_samples == j_ds.n_samples
    if case == "partial_batch":
        assert p_ds.n_samples % 8 != 0    # the tail batch is partial
    for _ in range(2):                     # two epochs: the generators stay in step
        p_batches, j_batches = list(p_ds), list(j_ds)
        assert len(p_batches) == len(j_batches) == len(p_ds)
        for (px, py), (jx, jy) in zip(p_batches, j_batches):
            assert px.dtype == torch.float32 and tuple(px.shape) == jx.shape
            np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(p_ds.epoch_indices(), j_ds.epoch_indices())
    idx = np.arange(min(5, p_ds.n_samples))
    np.testing.assert_array_equal(p_ds.start_indices(idx).numpy(),
                                  np.asarray(j_ds.start_indices(idx)))
    fp, fj = p_ds.fork(3), j_ds.fork(3)
    np.testing.assert_array_equal(fp.epoch_indices(), fj.epoch_indices())


def test_device_dataset_refuses(tmp_path):
    """Unported batch kinds raise; a log that is not on disk raises; the
    default device is the card."""
    p_store, _ = _stores()
    for kw in ({"sharding": object()}, {"extra_frames": [p_store.frames]}):
        with pytest.raises(NotImplementedError):
            p_pipe.DeviceDataset(p_store, 8, device="cpu", **kw)
    with pytest.raises(FileNotFoundError):
        p_pipe.FrameStore.from_processed_dir(
            {"train_logs": ["Log1"], "data_dir": str(tmp_path)}, "train")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_pipe.DeviceDataset(p_store, 8)

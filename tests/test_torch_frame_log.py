"""The frame-log file contract: logs written by either package load in the
other, through ``from_processed_dir``, ``from_raw_camera`` and the pooled
and large iterators, with frames, actions, traffic, sensors and
``file_idx`` bit for bit; both packages write the same bytes; state.csv
parses as pandas parses it, or, where the two roundings differ, to the
same labels and float32 sensors."""

import filecmp

import numpy as np
import pandas as pd
import pytest

from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu.data import frame_log as j_fl
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu_torch.config import compose as p_compose
from carla_imitation_learning_tpu_torch.data import frame_log as p_fl
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe

N, HW = 60, 32
STORE_FIELDS = ("frames", "actions", "traffic", "sensors", "file_idx")


def _write(fl, root):
    state = fl.write_synthetic_log(root, log="Log1", cameras=("camera", "semantic"),
                                   n_frames=N, height=HW, width=HW, seed=3)
    counts = fl.split_frames(root / "raw" / "Log1", root / "processed" / "Log1")
    return state, counts


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """{writer: data_dir} for a log written by each package."""
    root = tmp_path_factory.mktemp("logs")
    out = {}
    for name, fl in (("jax", j_fl), ("port", p_fl)):
        out[name] = root / name
        out[f"{name}_counts"] = _write(fl, out[name])[1]
    return out


def _cfgs(data_dir, *extra):
    overrides = ["model=imitation", f"data_dir={data_dir}", "BATCH_SIZE=4",
                 "camera=semantic", "TEST_SIZE=0.2", *extra]
    return j_compose("config", overrides=overrides), p_compose("config", overrides=overrides)


def _assert_stores_equal(p, j):
    for f in STORE_FIELDS:
        a, b = np.asarray(getattr(p, f)), np.asarray(getattr(j, f))
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)


def test_writers_make_identical_files(logs):
    """Same file lists and bytes: PNG frames, both state.csv files and the
    split folders (hard links or copies of the same files)."""
    assert logs["jax_counts"] == logs["port_counts"] == {"train": 96, "val": 12, "test": 12}
    j_root, p_root = logs["jax"], logs["port"]
    j_files = sorted(p.relative_to(j_root) for p in j_root.rglob("*") if p.is_file())
    p_files = sorted(p.relative_to(p_root) for p in p_root.rglob("*") if p.is_file())
    assert j_files == p_files and len(j_files) == 2 * 2 * N + 2
    for rel in j_files:
        assert filecmp.cmp(j_root / rel, p_root / rel, shallow=False), rel


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_from_processed_dir_matches(logs, writer, split):
    """camera=semantic has no ``<split>/Log1`` folder, so both take the
    camera's folder."""
    jcfg, pcfg = _cfgs(logs[writer])
    _assert_stores_equal(p_pipe.FrameStore.from_processed_dir(pcfg, split),
                         j_pipe.FrameStore.from_processed_dir(jcfg, split))


def test_from_processed_dir_falls_back_to_sole_folder(tmp_path):
    """A split holding one frame folder that is neither ``<log>`` nor the
    configured camera's is taken by both."""
    p_fl.write_synthetic_log(tmp_path, cameras=("camera",), n_frames=20, height=16,
                             width=16)
    p_fl.split_frames(tmp_path / "raw" / "Log1", tmp_path / "processed" / "Log1")
    jcfg, pcfg = _cfgs(tmp_path)
    _assert_stores_equal(p_pipe.FrameStore.from_processed_dir(pcfg, "train"),
                         j_pipe.FrameStore.from_processed_dir(jcfg, "train"))
    (tmp_path / "processed" / "Log1" / "train" / "other").mkdir()
    for pipe, cfg in ((p_pipe, pcfg), (j_pipe, jcfg)):
        with pytest.raises(FileNotFoundError):
            pipe.FrameStore.from_processed_dir(cfg, "train")


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("camera", ["camera", "semantic"])
def test_from_raw_camera_matches(logs, writer, camera):
    jcfg, pcfg = _cfgs(logs[writer])
    p = p_pipe.FrameStore.from_raw_camera(pcfg, "Log1", camera)
    _assert_stores_equal(p, j_pipe.FrameStore.from_raw_camera(jcfg, "Log1", camera))
    assert len(p) == N and p.frames.shape == (N, HW, HW)


def _batches(loaders):
    return {k: [tuple(np.asarray(t) for t in b) for b in loader]
            for k, loader in loaders.items()}


@pytest.mark.parametrize("factory", ["sequential", "pooled", "large"])
def test_iterators_match(logs, factory):
    """Every split's batches, in order, bit for bit (shuffled train split)."""
    jcfg, pcfg = _cfgs(logs["port"], "shuffle_train=True", "seed=5")
    if factory == "sequential":
        j = j_pipe.sequential_train_val_test_iterator(jcfg)
        p = p_pipe.sequential_train_val_test_iterator(pcfg, device="cpu")
    elif factory == "pooled":
        j = j_pipe.train_val_test_iterator(jcfg)
        p = p_pipe.train_val_test_iterator(pcfg, device="cpu")
    else:
        j = j_pipe.large_train_val_test_iterator(jcfg)
        p = p_pipe.large_train_val_test_iterator(pcfg, device="cpu")
    jb, pb = _batches(j), _batches(p)
    assert set(jb) == set(pb) == {"train_dataloader", "val_dataloader", "test_dataloader"}
    for k in jb:
        assert len(jb[k]) == len(pb[k]) > 0, k
        for (jx, jy), (px, py) in zip(jb[k], pb[k]):
            np.testing.assert_array_equal(px, jx, err_msg=k)
            np.testing.assert_array_equal(py, jy, err_msg=k)


def test_aux_iterator_waits_for_its_item(logs):
    """The aux iterator, which waited for its queue item until the aux
    family was ported, now gives the JAX package's ``((x, sensor), (traffic,
    action))`` batches on every split, bit for bit."""
    jcfg, pcfg = _cfgs(logs["port"], "shuffle_train=True", "seed=5")
    j = j_pipe.sequential_aux_train_val_test_iterator(jcfg)
    p = p_pipe.sequential_aux_train_val_test_iterator(pcfg, device="cpu")
    for k in ("train_dataloader", "val_dataloader", "test_dataloader"):
        assert len(j[k]) == len(p[k]) > 0, k
        for ((jx, js), jy), ((px, ps), py) in zip(j[k], p[k]):
            for a, b in ((px, jx), (ps, js), (py, jy)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


def _threshold_state(n=400, seed=0):
    """Controls at and around the 9-class thresholds (steer ±0.05; throttle
    0, 0.5, 1; brake 0, 1), plus values whose %.6g text is a rounding
    boundary, and random sensors."""
    rng = np.random.default_rng(seed)
    near = np.array([0.05, -0.05, 0.0500001, -0.0500001, 0.0499999, -0.0499999,
                     0.05000005, 0.04999995, 0.0, 1.0, -1.0, 0.5, 1 / 3, 2e-7])
    steer = np.concatenate([near, rng.choice(near, n - len(near)) + rng.choice(
        [0.0, 1e-9, -1e-9, 5e-8], n - len(near))])
    pairs = np.array([(1.0, 0.0), (0.5, 0.0), (0.0, 1.0), (0.5000001, 0.0),
                      (0.9999999, 0.0), (0.0, 0.9999999), (0.25, 0.0)])
    pick = pairs[rng.integers(0, len(pairs), n)]
    return p_fl.StateLog(
        steer=steer, throttle=pick[:, 0], brake=pick[:, 1],
        trafficlight=(rng.random(n) < 0.3).astype(np.float64),
        current_steer=rng.normal(0, 0.3, n), speed_long=rng.uniform(0, 12, n) / 7,
        speed=rng.uniform(0, 12, n) / 3)


def test_state_csv_parse_agrees_with_pandas(tmp_path):
    """The port reads a JAX-written state.csv to pandas' values, bit for
    bit where both round alike; where they differ, the labels and the
    float32 sensors must still agree."""
    path = tmp_path / "state.csv"
    j_fl.save_state_csv(path, _threshold_state())
    p_fl.save_state_csv(tmp_path / "port.csv", _threshold_state())
    assert path.read_bytes() == (tmp_path / "port.csv").read_bytes()
    port, jax_ = p_fl.load_state_csv(path), j_fl.load_state_csv(path)
    df = pd.read_csv(path)
    for col in p_fl.STATE_COLUMNS:
        a = getattr(port, col)
        assert a.dtype == np.float64
        b = np.asarray(getattr(jax_, col), np.float64)
        np.testing.assert_array_equal(b, df[col].to_numpy(np.float64))
        differ = a != b
        assert np.abs(a - b)[differ].max(initial=0) <= 2 * np.spacing(np.abs(b)).max(), col
    p_store = p_pipe.FrameStore.from_arrays(np.zeros((len(port), 2, 2), np.uint8), port)
    j_store = j_pipe.FrameStore.from_arrays(np.zeros((len(port), 2, 2), np.uint8), jax_)
    for f in ("actions", "traffic", "sensors"):
        np.testing.assert_array_equal(getattr(p_store, f), getattr(j_store, f), err_msg=f)
    assert len(np.unique(p_store.actions)) >= 6


def test_state_csv_requires_columns(tmp_path):
    path = tmp_path / "state.csv"
    path.write_text("steer,throttle\n0.1,1\n")
    with pytest.raises(ValueError, match="missing columns"):
        p_fl.load_state_csv(path)


def test_frame_log_reads_match(logs):
    """``FrameLog`` ordering, ``file_idx`` and both decoders, on a folder
    whose names are not zero-padded."""
    d = logs["jax"] / "raw" / "Log1" / "camera"
    p, j = p_fl.FrameLog(d), j_fl.FrameLog(d)
    assert p.names == j.names and p.names[:11] == [f"{i}.png" for i in range(1, 12)]
    np.testing.assert_array_equal(p.file_idx, j.file_idx)
    np.testing.assert_array_equal(p.read_all_gray_u8(), j.read_all_gray_u8())
    for i in (0, 17):
        np.testing.assert_array_equal(p.read_gray_f32(i), j.read_gray_f32(i))


def test_save_frames_gray_and_jpeg_match(tmp_path):
    """Grayscale PNG (threaded) and RGB JPEG from both writers: same bytes."""
    gray = np.random.default_rng(2).integers(0, 256, (9, 12, 20), dtype=np.uint8)
    rgb = p_fl.synthetic_frames(3, 12, 20, seed=1)
    for name, fl in (("j", j_fl), ("p", p_fl)):
        assert fl.save_frames(tmp_path / name / "gray", gray, workers=3) == 9
        fl.save_frames(tmp_path / name / "rgb", rgb, image_format="jpeg", start_index=5)
    for sub, names in (("gray", [f"{i}.png" for i in range(1, 10)]),
                       ("rgb", ["5.jpeg", "6.jpeg", "7.jpeg"])):
        for n in names:
            assert filecmp.cmp(tmp_path / "j" / sub / n, tmp_path / "p" / sub / n,
                               shallow=False), (sub, n)
    np.testing.assert_array_equal(p_fl.FrameLog(tmp_path / "p" / "gray").read_all_gray_u8(),
                                  gray)

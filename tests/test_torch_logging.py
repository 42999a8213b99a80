"""The port's metric sinks, callbacks and ETL against the JAX package's:
TensorBoard event records byte for byte (the JAX writer's files load in
TensorBoard, ``tests/test_tb_writer.py``), the same JSONL and CSV rows,
the same best-metric, per-class and confusion outputs, and the same
compressed and resized frame files."""

import csv
import filecmp
import inspect
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu import callbacks as j_cb
from carla_imitation_learning_tpu.data import etl as j_etl
from carla_imitation_learning_tpu.data import frame_log as j_fl
from carla_imitation_learning_tpu.data.pipeline import DeviceDataset as JDataset
from carla_imitation_learning_tpu.data.pipeline import FrameStore as JStore
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu.utils import logging as j_log
from carla_imitation_learning_tpu.utils import tb_writer as j_tb
from carla_imitation_learning_tpu_torch import callbacks as p_cb
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data import etl as p_etl
from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
from carla_imitation_learning_tpu_torch.models import PolicyCNN
from carla_imitation_learning_tpu_torch.utils import logging as p_log
from carla_imitation_learning_tpu_torch.utils import tb_writer as p_tb


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages' sinks read the same fixed time."""
    for mod in (j_tb, p_tb, j_log, p_log):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)


def test_crc32c_and_records_match():
    assert p_tb._crc32c(b"\x00" * 32) == 0x8A9136AA
    assert p_tb._crc32c(b"123456789") == 0xE3069283
    for data in (b"", b"abc", bytes(range(256)) * 3):
        assert p_tb._masked_crc(data) == j_tb._masked_crc(data)
    for args in ((1.5, 3, p_tb._scalar_value("losses/train_loss", 0.25)), (2.0, None, b""),
                 (3.0, 2 ** 40, p_tb._scalar_value("acc", -1e-7))):
        assert p_tb._event(*args) == j_tb._event(*args)
    assert p_tb._event(1.0, file_version="brain.Event:2") == \
        j_tb._event(1.0, file_version="brain.Event:2")
    assert "import torch" not in inspect.getsource(p_tb)


def _log(mod, root):
    lg = mod.MetricLogger(root, "run")
    lg.add_scalars("losses", {"train_loss": 0.5, "val_loss": 0.75}, 0)
    lg.add_scalars_flat({"train_accuracy": 0.25, "extra": "n/a"}, 1)
    lg.add_scalar("best_val_loss", np.float32(0.125), 2)
    lg.close()
    return lg


def test_metric_logger_writes_what_jax_writes(tmp_path, fixed_clock):
    jl, pl = _log(j_log, tmp_path / "jax"), _log(p_log, tmp_path / "port")
    assert json.dumps(pl.history) == json.dumps(jl.history)  # NaN included
    for name in ("metrics.jsonl", "metrics.csv"):
        assert filecmp.cmp(tmp_path / "jax" / "run" / name, tmp_path / "port" / "run" / name,
                           shallow=False), name
    rows = [json.loads(line) for line in
            (tmp_path / "port" / "run" / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["losses/val_loss"] == 0.75 and np.isnan(rows[1]["extra"])
    with open(tmp_path / "port" / "run" / "metrics.csv", newline="") as f:
        assert len(list(csv.reader(f))) >= 4
    [jev] = (tmp_path / "jax" / "run").glob("events.out.tfevents.*")
    [pev] = (tmp_path / "port" / "run").glob("events.out.tfevents.*")
    assert pev.name == jev.name and pev.read_bytes() == jev.read_bytes()


class _Trainer:
    def __init__(self, logger):
        self.logger = logger


def test_best_metric_scores_match(tmp_path, fixed_clock):
    rows = [{"train_loss": 2.0, "val_loss": 1.5, "val_accuracy": 0.2},
            {"train_loss": 1.0, "val_loss": 1.7, "val_accuracy": 0.4, "train_accuracy": 0.5},
            {"train_loss": 1.2, "val_loss": 1.1, "val_accuracy": 0.3}]
    outs = []
    for cb_mod, log_mod, name in ((j_cb, j_log, "jax"), (p_cb, p_log, "port")):
        cb = cb_mod.SaveBestMetricScores()
        trainer = _Trainer(log_mod.MetricLogger(tmp_path / name, "run"))
        for epoch, m in enumerate(rows):
            cb.on_epoch_end(trainer, None, epoch, m, None)
        trainer.logger.close()
        outs.append((cb.best, trainer.logger.history))
    assert outs[0] == outs[1]
    assert outs[1][0] == {"best_train_loss": 1.0, "best_val_loss": 1.1,
                          "best_train_accuracy": 0.5, "best_val_accuracy": 0.4}


def test_per_class_callbacks_match(tmp_path):
    """Heatmap and confusion callbacks with loaders, on one model carried
    across, write the same files; without loaders (as the ``Trainer``
    calls them) they do nothing."""
    model = JPolicyCNN(dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 4)))["params"]
    port = PolicyCNN(dtype=torch.float32)
    port.load_state_dict(convert.policy_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    jstore = JStore.synthetic(n=60, height=32, width=32, seed=2)
    pstore = FrameStore.synthetic(n=60, height=32, width=32, seed=2)
    jloaders = {"val_dataloader": JDataset(jstore, 8, drop_last=False)}
    ploaders = {"val_dataloader": DeviceDataset(pstore, 8, drop_last=False, device="cpu")}
    jstate = SimpleNamespace(apply_fn=model.apply, params=params)
    pstate = SimpleNamespace(model=port)
    for j_cls, p_cls, name in ((j_cb.SaveMetricsHeatmap, p_cb.SaveMetricsHeatmap,
                                "per_class_metrics.json"),
                               (j_cb.SaveConfusionMatrix, p_cb.SaveConfusionMatrix,
                                "confusion_matrix.npy")):
        jc = j_cls(9, out_dir=str(tmp_path / "jax"))
        pc = p_cls(9, out_dir=str(tmp_path / "port"))
        pc.on_fit_end(None, pstate, [])
        assert not (tmp_path / "port" / name).exists()
        jc.on_fit_end(None, jstate, [], loaders=jloaders)
        pc.on_fit_end(None, pstate, [], loaders=ploaders)
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name
    assert np.load(tmp_path / "port" / "confusion_matrix.npy").sum() == 60 - 4


@pytest.fixture(scope="module")
def raw_log(tmp_path_factory):
    root = tmp_path_factory.mktemp("etl")
    j_fl.write_synthetic_log(root, cameras=("camera",), n_frames=12, height=24, width=40,
                             seed=5)
    return {"data_dir": str(root), "train_logs": ["Log1"], "camera": ["camera"]}


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_compress_data_matches(raw_log, tmp_path, suffix):
    j = j_etl.compress_data(raw_log, out_path=str(tmp_path / f"jax{suffix}"))
    p = p_etl.compress_data(raw_log, out_path=str(tmp_path / f"port{suffix}"))
    assert p.suffix == j.suffix
    np.testing.assert_array_equal(p_etl.load_compressed(p), j_etl.load_compressed(j))
    np.testing.assert_array_equal(p_etl.load_compressed(j), j_etl.load_compressed(p))
    assert p_etl.load_compressed(p).shape == (12, 24, 40)
    if suffix == ".npz":
        np.testing.assert_array_equal(np.load(p)["file_idx"], np.arange(12))


def test_resize_camera_folder_matches(raw_log, tmp_path):
    j = j_etl.resize_camera_folder(raw_log, "Log1", "camera", size=16)
    names = sorted(x.name for x in j.iterdir())
    saved = {n: (j / n).read_bytes() for n in names}
    p = p_etl.resize_camera_folder(raw_log, "Log1", "camera", size=16)
    assert p == j and sorted(x.name for x in p.iterdir()) == names and len(names) == 12
    for n in names:
        assert (p / n).read_bytes() == saved[n], n

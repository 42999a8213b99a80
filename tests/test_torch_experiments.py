"""The port's ``config``, ``cli`` and the collection and evaluation
experiments: ``compose`` equals the JAX package's for every preset the
port carries, with overrides; ``list`` and ``run``; a tiny
``collect_data`` on the CPU (plain versions) writes a log that the JAX
package's ``from_raw_camera`` reads to the port's store, bit for bit, and a
packed store equal to it; ``bc`` on that log and ``closed_loop_eval`` from
the saved checkpoint; the options that wait for other modules raise."""

import contextlib
import fcntl
import io
import json
from pathlib import Path

import numpy as np
import pytest

from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu.native import NativeFrameStore as JNative
from carla_imitation_learning_tpu_torch import cli
from carla_imitation_learning_tpu_torch import experiments as ex
from carla_imitation_learning_tpu_torch.config import compose as p_compose
from carla_imitation_learning_tpu_torch.data import frame_log as p_fl
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe

CONFIG_DIR = Path(ex.__file__).resolve().parent / "configs"
PRESETS = sorted(p.stem for p in (CONFIG_DIR / "experiment").glob("*.yaml"))
# a town and camera small enough for the CPU
TINY = ["sim.n_agents=2", "sim.town.blocks=2", "sim.town.n_buildings=4",
        "render.height=64", "render.width=64", "render.max_triangles=256"]


@pytest.fixture(scope="module")
def jax_native_library():
    """The JAX package's frame-store library, built once under a file lock:
    its ``build_library`` compiles in place, so test workers must not build it at the
    same time."""
    from carla_imitation_learning_tpu.native import framestore as j_fs

    j_fs._LIB_DIR.mkdir(parents=True, exist_ok=True)
    with open(j_fs._LIB_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        assert j_fs.build_library() is not None, "g++ build of the JAX library failed"


@pytest.mark.parametrize("overrides", [
    [], ["model=imitation"], ["model=imitation", "trainer=debug_trainer", "BATCH_SIZE=8",
                              "sim.n_envs=16", "render.fog_density=0.01", "new_key=[1, 2]",
                              "bc_cameras=['camera']", "mesh.axes.model=1"],
] + [["model=imitation", f"experiment={p}"] for p in PRESETS],
    ids=lambda o: ",".join(o) or "defaults")
def test_compose_matches_jax(overrides):
    assert p_compose("config", overrides=overrides).to_dict() == \
        j_compose("config", overrides=overrides).to_dict()


def test_presets_are_the_ported_experiments():
    assert PRESETS == ["bc", "bc_streaming", "closed_loop_eval", "collect", "scenario_eval",
                       "split_folders", "test_eval"]
    names = {p_compose("config", overrides=[f"experiment={p}"])["experiment_name"]
             for p in PRESETS}
    assert names == set(ex.EXPERIMENTS) == {"bc", "bc_streaming", "closed_loop_eval",
                                            "collect_data", "scenario_eval", "split_folders",
                                            "test_eval"}


def test_compose_interpolates_and_rejects(tmp_path):
    cfg = p_compose("config")
    assert cfg.log_dir.startswith("logs/") and "${" not in cfg.log_dir
    assert cfg.sim.town.blocks == cfg["sim"]["town"]["blocks"] == 3
    with pytest.raises(ValueError, match="key=value"):
        p_compose("config", overrides=["BATCH_SIZE"])


def test_cli_list_and_errors(capsys):
    assert cli.main(["list"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == sorted(ex.EXPERIMENTS)
    assert cli.main(["run", "no_such_experiment"]) == 2
    assert cli.main(["run"]) == 2


def _run(capsys, *args):
    assert cli.main(["run", *args, "--json"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """``collect_data`` at 2 envs × 32 steps on the CPU, then
    ``split_folders`` from its preset."""
    root = tmp_path_factory.mktemp("collect")
    base = ["-o", f"data_dir={root / 'data'}", "-o", f"log_dir={root / 'logs'}",
            "-o", "device=cpu", "-o", "train_logs=['SimLog1']"]
    for t in TINY:
        base += ["-o", t]
    out = {}
    for key, args in (("collect", ["collect_data", "-o", "n_envs=2", "-o", "n_steps=32"]),
                      ("split", ["-o", "experiment=split_folders"])):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            assert cli.main(["run", *args, *base, "--json"]) == 0
        out[key] = json.loads(text.getvalue().strip().splitlines()[-1])
    return root, base, out


def test_collect_data_log_reads_equal_in_jax(collected, jax_native_library):
    root, _, out = collected
    assert out["collect"]["frames"] == 64 and sum(out["collect"]["action_histogram"]) == 64
    assert out["split"]["counts"] == {"train": 51, "val": 6, "test": 7}
    cfg_over = ["model=imitation", f"data_dir={root / 'data'}"]
    p = p_pipe.FrameStore.from_raw_camera(p_compose("config", overrides=cfg_over),
                                          "SimLog1", "camera")
    j = j_pipe.FrameStore.from_raw_camera(j_compose("config", overrides=cfg_over),
                                          "SimLog1", "camera")
    for f in ("frames", "actions", "traffic", "sensors", "file_idx"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f)
    packed = JNative(out["collect"]["framestore"])
    try:
        # the packed store holds the in-memory store: PNG is lossless, and
        # the expert's labels come back from state.csv's controls
        np.testing.assert_array_equal(packed.frames, j.frames)
        np.testing.assert_array_equal(packed.actions, j.actions)
        np.testing.assert_array_equal(packed.traffic, j.traffic)
        np.testing.assert_allclose(packed.sensors, j.sensors, rtol=1e-5, atol=1e-6)
        assert packed.starts[::32].all() and packed.starts.sum() >= 2
    finally:
        packed.close()
    assert p.frames.shape == (64, 64, 64)
    state = p_fl.load_state_csv(root / "data" / "raw" / "state.csv")
    assert len(state) == 64


def test_bc_then_closed_loop_eval(collected, capsys):
    """``bc`` on the collected log writes a best-k checkpoint;
    ``closed_loop_eval`` scores it beside the expert."""
    root, base, _ = collected
    res = _run(capsys, "bc", *base, "-o", "bc_cameras=['camera']", "-o", "image_height=64",
               "-o", "image_width=64", "-o", "NUM_EPOCHS=1", "-o", "BATCH_SIZE=4",
               "-o", "compute_dtype=float32")
    best = res["camera"]["best_path"]
    assert Path(best, "checkpoint.pt").is_file()
    assert json.loads(Path(best).parent.joinpath("index.json").read_text())[0]["step"] == 0
    assert np.isfinite(res["camera"]["test"]["test_loss"])
    logs = root / "logs" / "imitation_camera"
    assert {p.name for p in logs.iterdir()} >= {"ckpt", "metrics.jsonl", "metrics.csv"}
    assert any(p.name.startswith("events.out.tfevents") for p in logs.iterdir())
    ev = _run(capsys, "closed_loop_eval", *base, "--checkpoint", best, "-o", "n_envs=2",
              "-o", "n_steps=6", "-o", "compute_dtype=float32")
    for who in ("policy", "expert"):
        assert ev[who]["env_steps"] == 12 and 0.0 <= ev[who]["driving_score"] <= 1.0
    assert ev["expert"]["action_agreement"] == 1.0


@pytest.mark.parametrize("experiment,overrides", [
    ("bc", ["augment=true"]), ("bc", ["mesh.enabled=true"]), ("bc", ["mesh.axes.data=4"]),
    ("collect_data", ["n_goals=2"]),
    ("closed_loop_eval", ["artifact=some_dir"]), ("closed_loop_eval", ["safety_shield=true"]),
    ("closed_loop_eval", ["policy_family=continuous"]),
    ("closed_loop_eval", ["policy_family=cil"]), ("closed_loop_eval", ["policy_arch=vit"]),
    ("closed_loop_eval", ["s2d_stem=true"]),
])
def test_unported_options_raise(tmp_path, experiment, overrides):
    cfg = p_compose("config", overrides=["model=imitation", "device=cpu",
                                         f"data_dir={tmp_path}", f"log_dir={tmp_path}",
                                         *TINY, *overrides])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ex.EXPERIMENTS[experiment](cfg)


def test_flag_reads_cli_spellings():
    cfg = p_compose("config", overrides=["a=false", "b=off", "c=True", "d=yes", "e=0"])
    assert [ex._flag(cfg, k) for k in "abcde"] == [False, False, True, True, False]
    assert ex._flag(cfg, "missing", True)

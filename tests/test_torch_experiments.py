"""The port's ``config``, ``cli`` and the collection and evaluation
experiments: ``compose`` equals the JAX package's for every preset the
port carries, with overrides; ``list`` and ``run``; a tiny
``collect_data`` on the CPU (plain versions) writes a log that the JAX
package's ``from_raw_camera`` reads to the port's store, bit for bit, and a
packed store equal to it; ``bc`` on that log and ``closed_loop_eval`` from
the saved checkpoint; the policy families (``bc_cil`` then ``route_eval``
of its checkpoint, ``bc_continuous``, goal-directed and continuous DAgger)
at toy size; ``dagger_uncertain`` through the CLI with the JAX
experiment's result keys; a mesh larger than the world raises, and a mesh
of one equals the unsharded run."""

import contextlib
import fcntl
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu.native import NativeFrameStore as JNative
from carla_imitation_learning_tpu_torch import cli
from carla_imitation_learning_tpu_torch import experiments as ex
from carla_imitation_learning_tpu_torch.config import compose as p_compose
from carla_imitation_learning_tpu_torch.data import frame_log as p_fl
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe
from carla_imitation_learning_tpu_torch.sim.world import SimParams

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
] + [["model=imitation", f"experiment={p}"] for p in PRESETS]
  + [["model=cil", "experiment=bc_cil"], ["model=imitation", "render=rich128"],
     ["model=imitation", "render=foggy128"], ["model=imitation", "sim=town_busy"],
     ["model=imitation", "sim=town_curved"], ["model=imitation", "sim=town_turns"]],
    ids=lambda o: ",".join(o) or "defaults")
def test_compose_matches_jax(overrides):
    assert p_compose("config", overrides=overrides).to_dict() == \
        j_compose("config", overrides=overrides).to_dict()


def test_presets_are_the_ported_experiments():
    assert PRESETS == ["bc", "bc_augmented", "bc_aux", "bc_aux_seg", "bc_cil",
                       "bc_continuous", "bc_raw_segment", "bc_rnn", "bc_streaming",
                       "bc_surround", "bc_vit", "closed_loop_eval", "collect",
                       "collect_multicamera", "collect_noise", "dagger", "dagger_online",
                       "dagger_uncertain", "debug", "dream_policy", "export_policy", "hpo",
                       "hpo_pbt", "hpo_vmap", "replay", "rl_finetune",
                       "route_eval", "scenario_eval", "split_folders", "test_eval",
                       "vae_leave_one_out", "vae_pooled", "world_model",
                       "world_model_imagine", "world_model_sweep"]
    names = {p_compose("config", overrides=[f"experiment={p}"])["experiment_name"]
             for p in PRESETS}
    assert names == set(ex.EXPERIMENTS) == {"bc", "bc_aux", "bc_cil", "bc_continuous",
                                            "bc_raw_segment", "bc_rnn", "bc_streaming",
                                            "bc_surround", "closed_loop_eval",
                                            "collect_data", "collect_multicamera", "dagger",
                                            "dagger_online", "dagger_uncertain",
                                            "dream_policy", "export_policy", "hpo",
                                            "hpo_pbt", "hpo_vmap", "replay", "rl_finetune",
                                            "route_eval", "scenario_eval", "split_folders",
                                            "test_eval", "vae_leave_one_out", "world_model",
                                            "world_model_imagine", "world_model_sweep",
                                            "vae_pooled"}


def test_multilane_town_preset_matches_jax():
    overrides = ["model=imitation", "sim=town_multilane", "experiment=bc_cil"]
    assert p_compose("config", overrides=overrides).to_dict() == \
        j_compose("config", overrides=overrides).to_dict()


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


MESH_OF_ONE = {
    "bc": ["NUM_EPOCHS=1", "BATCH_SIZE=8", "synthetic_frames=60", "image_height=64",
           "image_width=64", "compute_dtype=float32", "trainer.num_sanity_val_steps=0",
           "bc_cameras=['camera']"],
    "closed_loop_eval": ["n_envs=2", "n_steps=6", "compute_dtype=float32"],
}


def _without_state(x):
    if isinstance(x, dict):
        return {k: _without_state(v) for k, v in x.items()
                if k not in ("state", "throughput", "best_path")}
    return x


@pytest.mark.parametrize("experiment,overrides", [
    ("bc", ["mesh.axes.model=2"]), ("bc", ["mesh.enabled=true"]), ("bc", ["mesh.axes.data=4"]),
    ("closed_loop_eval", ["mesh.enabled=true"]), ("route_eval", ["mesh.axes.data=4"]),
])
def test_unported_options_raise(tmp_path, experiment, overrides):
    """The mesh options (named when they raised as not ported): axes that
    ask for more ranks than the world (one process here) has raise
    ``ValueError`` before anything runs; ``mesh.enabled=true`` is a mesh of
    one rank whose collectives are the identity, so its run equals the
    unsharded one."""
    if overrides != ["mesh.enabled=true"]:
        cfg = p_compose("config", overrides=["model=imitation", "device=cpu",
                                             f"data_dir={tmp_path}", f"log_dir={tmp_path}",
                                             *TINY, *overrides])
        with pytest.raises(ValueError, match="asks? for more ranks than the world has"):
            ex.EXPERIMENTS[experiment](cfg)
        return
    results = []
    for tag, extra in (("plain", []), ("mesh", overrides)):
        cfg = p_compose("config", overrides=[
            "model=imitation", "device=cpu", f"data_dir={tmp_path}/data",
            f"log_dir={tmp_path}/{tag}", *TINY, *MESH_OF_ONE[experiment], *extra])
        results.append(_without_state(ex.EXPERIMENTS[experiment](cfg)))
    assert results[0] == results[1]


MESH_SIZES = {
    "dagger_online": ["rounds=2", "n_envs=2", "n_steps=8", "train_steps_per_round=2",
                      "eval_steps=4", "BATCH_SIZE=4", "compute_dtype=float32"],
    "rl_finetune": ["n_envs=2", "rollout_steps=4", "iterations=1", "eval_envs=2",
                    "eval_steps=4", "rl_update_epochs=1", "rl_num_minibatches=2",
                    "compute_dtype=float32"],
}


def _untimed(x):
    """A result without its wall-clock figures and its paths."""
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items()
                if "seconds" not in k and "per_sec" not in k and k != "actor_checkpoint"}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


@pytest.mark.parametrize("experiment", ["dagger_online", "rl_finetune"])
def test_mesh_waits_for_item_6b(tmp_path, experiment):
    """Online DAgger's sharded buffer and PPO's sharded rollouts (the item
    that this test's name recalls, when both raised under a mesh): under a
    mesh of one rank, whose collectives are the identity, each run equals
    the unsharded one (two ranks: ``tests/test_torch_online_dagger_mesh.py``
    and ``tests/test_torch_ppo_mesh.py``)."""
    results = []
    for tag, extra in (("plain", []), ("mesh", ["mesh.enabled=true"])):
        cfg = p_compose("config", overrides=[
            "model=imitation", "device=cpu", f"data_dir={tmp_path}/data",
            f"log_dir={tmp_path}/{tag}", *TINY, *MESH_SIZES[experiment], *extra])
        results.append(_untimed(ex.EXPERIMENTS[experiment](cfg)))
    assert results[0] == results[1]


@pytest.mark.parametrize("experiment,overrides", [
    ("collect_data", ["n_goals=2", "n_envs=2", "n_steps=12"]),
    ("closed_loop_eval", ["policy_family=continuous", "n_envs=2", "n_steps=4"]),
    ("closed_loop_eval", ["policy_family=cil", "n_envs=2", "n_steps=4"]),
    ("closed_loop_eval", ["safety_shield=true", "n_envs=2", "n_steps=4"]),
    ("closed_loop_eval", ["s2d_stem=true", "policy_family=continuous", "n_envs=2",
                          "n_steps=4"]),
    ("bc", ["s2d_stem=true", "bc_cameras=['camera']", "image_height=64", "image_width=64",
            "NUM_EPOCHS=1", "BATCH_SIZE=4", "synthetic_frames=80"]),
    ("closed_loop_eval", ["policy_arch=vit", "vit_dim=32", "vit_depth=1", "vit_heads=2",
                          "n_envs=2", "n_steps=4"]),
    ("closed_loop_eval", ["surround_cameras=['camera', 'FL']", "n_envs=2", "n_steps=4"]),
    ("bc_cil", ["surround_cameras=['camera', 'FR']", "mirror_collection=true", "n_envs=2",
                "n_steps=48", "NUM_EPOCHS=1", "BATCH_SIZE=4"]),
    ("bc_continuous", ["surround_cameras=['camera', 'RR']", "n_envs=2", "n_steps=24",
                       "eval_envs=2", "eval_steps=4", "NUM_EPOCHS=1", "BATCH_SIZE=4"]),
])
def test_options_now_run(tmp_path, experiment, overrides):
    """The options these experiments raised on before the policy families,
    the shield, the space-to-depth stem, the ViT and the surround rigs were
    ported now run, at toy size on the CPU."""
    cfg = p_compose("config", overrides=["model=imitation", "device=cpu",
                                         "compute_dtype=float32", f"data_dir={tmp_path}",
                                         f"log_dir={tmp_path}", *TINY, *overrides])
    res = ex.EXPERIMENTS[experiment](cfg)
    if experiment == "collect_data":
        assert res["frames"] == 24 and sum(res["action_histogram"]) == 24
        assert cfg.get_dotted("sim.town.turn_fans") is True
    elif experiment == "bc":
        assert np.isfinite(res["camera"]["test"]["test_loss"])
        assert tuple(res["camera"]["state"].model.trunk.convs[0].weight.shape) == (16, 36, 3, 3)
    elif experiment in ("bc_cil", "bc_continuous"):
        # two views of four frames: eight input channels
        assert res["state"].model.trunk.convs[0].weight.shape[1] == 8
        assert np.isfinite(res["test"]["test_loss"])
        if experiment == "bc_continuous":
            assert res["eval"]["env_steps"] == 8
    else:
        assert res["policy"]["env_steps"] == 8 and 0.0 <= res["policy"]["driving_score"] <= 1.0
        assert ("shield_active_frac" in res["policy"]) == ("safety_shield=true" in overrides)
        assert "shield_active_frac" not in res["expert"]


def test_policy_family_unknown(tmp_path):
    cfg = p_compose("config", overrides=["model=imitation", "device=cpu", *TINY,
                                         "policy_family=ppo"])
    with pytest.raises(ValueError, match="policy_family"):
        ex.EXPERIMENTS["closed_loop_eval"](cfg, n_envs=2, n_steps=2)


def _family_base(tmp_path):
    base = ["-o", f"data_dir={tmp_path / 'data'}", "-o", f"log_dir={tmp_path / 'logs'}",
            "-o", "device=cpu", "-o", "compute_dtype=float32", "-o", "BATCH_SIZE=4"]
    for t in TINY:
        base += ["-o", t]
    return base


def test_bc_cil_then_route_eval(tmp_path, capsys):
    """``bc_cil`` from its preset (multi-lane town with turn fans, mirrored
    half, balanced by action and command), goal-directed with 2 goals; then
    ``route_eval`` of its checkpoint as a CIL policy beside the expert."""
    base = _family_base(tmp_path)
    res = _run(capsys, "-o", "experiment=bc_cil", *base, "-o", "n_envs=2", "-o", "n_steps=60",
               "-o", "n_goals=2", "-o", "NUM_EPOCHS=1")
    assert len(res["command_histogram"]) == 6 and sum(res["command_histogram"]) == 120
    assert np.isfinite(res["test"]["test_loss"]) and "test_speed_loss" in res["test"]
    best = res["best_path"]
    ev = _run(capsys, "-o", "experiment=route_eval", *base, "--checkpoint", best,
              "-o", "policy_family=cil", "-o", "n_envs=2", "-o", "n_steps=8", "-o", "n_goals=2")
    assert len(ev["goals"]) == 2
    for who in ("policy", "expert"):
        r = ev[who]
        assert r["env_steps"] == 16 and r["goals"] == 2
        assert r["attempts"] == r["arrivals"] + r["crashes"] + r["timeouts"]


def test_bc_continuous(tmp_path, capsys):
    res = _run(capsys, "-o", "experiment=bc_continuous", *_family_base(tmp_path),
               "-o", "n_envs=2", "-o", "n_steps=40", "-o", "eval_envs=2", "-o", "eval_steps=6",
               "-o", "NUM_EPOCHS=1")
    assert {"steer_std", "accel_mean"} == set(res["label_stats"])
    assert np.isfinite(res["test"]["test_steer_mse"])
    assert res["eval"]["env_steps"] == 12


@pytest.mark.parametrize("experiment,overrides", [
    ("dagger", ["policy_family=cil", "n_goals=2", "rounds=2", "n_steps=24",
                "epochs_per_round=1"]),
    ("dagger", ["policy_family=continuous", "rounds=2", "n_steps=24", "epochs_per_round=1"]),
    ("dagger_online", ["policy_family=cil", "n_goals=2", "rounds=2", "n_steps=12",
                       "train_steps_per_round=2", "eval_steps=6"]),
])
def test_dagger_families(tmp_path, capsys, experiment, overrides):
    args = [experiment, *_family_base(tmp_path), "-o", "n_envs=2"]
    for o in overrides:
        args += ["-o", o]
    res = _run(capsys, *args)
    if experiment == "dagger":
        assert [r["round"] for r in res["rounds"]] == [0, 1]
        assert all(np.isfinite(r["train_loss"]) for r in res["rounds"])
    else:
        assert len(res["loss_per_round"]) == 2 and res["agreement_per_round"][0] == 1.0
    if "n_goals=2" in overrides:
        r = res["routes"]
        assert r["goals"] == 2 and r["attempts"] == r["arrivals"] + r["crashes"] + r["timeouts"]


def test_flag_reads_cli_spellings():
    cfg = p_compose("config", overrides=["a=false", "b=off", "c=True", "d=yes", "e=0"])
    assert [ex._flag(cfg, k) for k in "abcde"] == [False, False, True, True, False]
    assert ex._flag(cfg, "missing", True)


def test_dagger_uncertain_through_cli(tmp_path, capsys, monkeypatch):
    """``run dagger_uncertain`` at toy size, and the JAX experiment's rounds
    with its collections, member states, training data and evaluations
    replaced (``tests/test_torch_dagger_ensemble.py`` holds the loop
    itself): the port's rounds carry JAX's keys beside the driving metrics
    of ``evaluate_policy`` (whose keys ``tests/test_torch_evaluate.py``
    holds to JAX's)."""
    import flax
    import jax.numpy as jnp

    import carla_imitation_learning_tpu.experiments as j_experiments
    import carla_imitation_learning_tpu.training.closed_loop as j_cl
    from carla_imitation_learning_tpu_torch.training import closed_loop as p_cl

    res = _run(capsys, "dagger_uncertain", *_family_base(tmp_path), "-o", "n_envs=2",
               "-o", "n_steps=12", "-o", "rounds=2", "-o", "epochs_per_round=1",
               "-o", "ensemble=2", "-o", "render.height=32", "-o", "render.width=32")
    assert [r["round"] for r in res["rounds"]] == [0, 1]
    assert all(r["ensemble"] == 2 and r["dataset_frames"] == 24 * (r["round"] + 1)
               for r in res["rounds"])

    @flax.struct.dataclass
    class MemberStates:
        params: jnp.ndarray

    class NoBatches:
        def __init__(self, store, *a, **kw):
            self.n_samples = len(store)

        def __iter__(self):
            return iter(())

    monkeypatch.setattr(j_cl, "collect_dataset", lambda *a, **kw: (
        j_pipe.FrameStore.synthetic(n=24, height=32, width=32, seed=1), None, None))
    monkeypatch.setattr(j_cl, "dagger_iteration", lambda *a, **kw: (
        j_pipe.FrameStore.synthetic(n=24, height=32, width=32, seed=2), None,
        {"policy_extra": jnp.zeros((12, 2))}))
    monkeypatch.setattr(j_cl, "evaluate_policy", lambda *a, **kw: {})
    monkeypatch.setattr(j_pipe, "DeviceDataset", NoBatches)
    monkeypatch.setattr(j_experiments, "create_train_state",
                        lambda *a, **kw: MemberStates(params=jnp.zeros(())))
    cfg = j_compose("config", overrides=["model=imitation", f"log_dir={tmp_path}",
                                         "render.height=32", "render.width=32",
                                         "compute_dtype=float32"])
    want = j_experiments.dagger_uncertain(cfg, rounds=2, n_envs=2, n_steps=12, epochs_per_round=1,
                              ensemble=2)
    traj = {k: torch.zeros((2, 2)) for k in ("speed", "collision", "offroad", "red_light",
                                            "done", "ran_red", "route_ds", "steer", "action",
                                            "expert_action")}
    eval_keys = set(p_cl.driving_metrics(SimParams(), traj))
    assert set(res) == set(want) == {"rounds"}
    for got, exp in zip(res["rounds"], want["rounds"]):
        assert set(got) == set(exp) | eval_keys

"""The port's hyperparameter-search experiments through ``cli.main run``
at toy size on the CPU, beside the JAX package's: ``hpo``, ``hpo_vmap`` and
``hpo_pbt`` at 32² on a 100-frame synthetic log (both packages' CLIs on
one data directory), ``world_model_sweep`` on a 2-trial grid, and the
continuous-vs-discrete A/B harness at a toy size.

The packages draw their initial weights differently, so trained metrics
are not compared; what must agree is what the search decides before
training: the result fields, the trial configs in order, the fields of
``trials.json`` and ``pbt_history.json``, and ``hpo_pbt``'s starting
rates (within one float32 ulp: ``exp`` of the same draws). The port's
concurrent ``hpo`` equals its serial one trial by trial. The JAX side of
``hpo_vmap`` and ``hpo_pbt`` runs with a toy ``_bc_vmap_trainable`` (its
fields, its ``pbt_run`` and its starting rates are what is compared;
``tests/test_torch_hpo.py`` holds the real trainable to JAX's), and the
JAX side of ``world_model_sweep`` with a stub ``world_model``."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import carla_imitation_learning_tpu.experiments as j_ex
from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu.cli import main as j_main
from carla_imitation_learning_tpu_torch import cli as p_cli
from test_torch_experiments import TINY

ROOT = Path(__file__).resolve().parents[1]
HPO = ["BATCH_SIZE=8", "synthetic_frames=100", "image_height=32", "image_width=32",
       "compute_dtype=float32"]


def _run(main, capsys, argv, overrides) -> dict:
    args = ["run", *argv, "--json"]
    for o in overrides:
        args += ["-o", o]
    assert main(args) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _toy_vmap_trainable(cfg, epochs):
    """JAX-side stand-in for ``_bc_vmap_trainable``: a scalar state whose
    score is fixed by its rate."""
    def init_fn(rng, lr):
        return {"w": jnp.zeros(())}

    def train_fn(state, lr):
        return state, {"mean_accuracy": jnp.minimum(lr * 50.0, 1.0), "val_loss": lr}

    return init_fn, train_fn


def _both(capsys, tmp_path, argv, extra=()) -> tuple[dict, dict]:
    """The JAX package's run first (it writes the synthetic log), then the
    port's on the same data, each with its own log_dir."""
    out = {}
    for name, main in (("jax", j_main), ("port", p_cli.main)):
        ov = [*HPO, *extra, f"data_dir={tmp_path / 'data'}", f"log_dir={tmp_path / name}"]
        out[name] = _run(main, capsys, argv, ov + (["device=cpu"] if name == "port" else []))
    return out["jax"], out["port"]


def _trials(path: Path) -> list:
    return json.loads((path / "trials.json").read_text())


def test_hpo_matches_jax_and_concurrent_equals_serial(tmp_path, capsys):
    j, p = _both(capsys, tmp_path, ["hpo"])
    assert set(p) == set(j) == {"best_config", "best_metrics", "n_trials", "n_failed"}
    assert p["n_trials"] == j["n_trials"] == 4 and p["n_failed"] == j["n_failed"] == 0
    jt, pt = _trials(tmp_path / "jax" / "hpo"), _trials(tmp_path / "port" / "hpo")
    assert [t["config"] for t in pt] == [t["config"] for t in jt]
    assert [set(t) for t in pt] == [set(t) for t in jt]
    assert all(set(t["metrics"]) == {"mean_accuracy"} for t in pt)
    serial = _run(p_cli.main, capsys, ["hpo"],
                  [*HPO, "device=cpu", "max_concurrent=1", f"data_dir={tmp_path / 'data'}",
                   f"log_dir={tmp_path / 'serial'}"])
    st = _trials(tmp_path / "serial" / "hpo")
    assert [t["config"] for t in st] == [t["config"] for t in pt]
    for a, b in zip(st, pt):
        np.testing.assert_allclose(a["metrics"]["mean_accuracy"],
                                   b["metrics"]["mean_accuracy"], rtol=1e-5)
    assert serial["best_config"] == p["best_config"]


def test_hpo_vmap_matches_jax_fields(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(j_ex, "_bc_vmap_trainable", _toy_vmap_trainable)
    j, p = _both(capsys, tmp_path, ["hpo_vmap"], ["lrs=[0.0001, 0.001, 0.01]", "epochs=1"])
    assert set(p) == set(j)
    assert p["lrs"] == j["lrs"] == [1e-4, 1e-3, 1e-2] and p["n_trials"] == j["n_trials"] == 3
    assert len(p["accuracies"]) == 3 and all(0.0 <= a <= 1.0 for a in p["accuracies"])
    assert np.isfinite(p["val_losses"]).all() and p["best_lr"] in p["lrs"]


def test_hpo_pbt_matches_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(j_ex, "_bc_vmap_trainable", _toy_vmap_trainable)
    j, p = _both(capsys, tmp_path, ["-o", "experiment=hpo_pbt"],
                 ["population=4", "generations=2"])
    assert set(p) == set(j)
    assert (p["population"], p["generations"]) == (j["population"], j["generations"]) == (4, 2)
    assert len(p["mean_accuracy_per_gen"]) == 2 and len(p["final_lrs"]) == 4
    jh = json.loads(Path(j["history_path"]).read_text())
    ph = json.loads(Path(p["history_path"]).read_text())
    assert [set(g) for g in ph] == [set(g) for g in jh]
    assert [g["generation"] for g in ph] == [0, 1]
    np.testing.assert_allclose(ph[0]["hparams"], jh[0]["hparams"], rtol=1.2e-7, atol=0)


def test_world_model_sweep_two_trials(tmp_path, capsys, monkeypatch):
    """The port runs two real ``world_model`` trials; the JAX sweep runs
    with its ``world_model`` stubbed, for its fields and trial order. With
    ``wm_z_size=16`` set, both trials train at z 16 though their configs
    say 64: the config key wins, in both packages."""
    grid = ["z_sizes=[64]", "rnns=['lstm', 'gru']", "losses=['mse']", "max_concurrent=2"]
    p = _run(p_cli.main, capsys, ["-o", "experiment=world_model_sweep"],
             [*TINY, *grid, "device=cpu", "compute_dtype=float32", "n_envs=2", "n_steps=24",
              "NUM_EPOCHS=1", "wm_batch=4", "wm_z_size=16", f"data_dir={tmp_path / 'data'}",
              f"log_dir={tmp_path / 'port'}"])
    seen = []

    def stub(cfg, n_envs, n_steps, z_size, rnn, image_loss):
        seen.append(int(cfg.get("wm_z_size", z_size)))
        return {"history": [{"val_loss": 1.0 + len(rnn), "val_recon_loss": 0.5}]}

    monkeypatch.setattr(j_ex, "world_model", stub)
    cfg = j_compose("config", overrides=[*grid, "wm_z_size=16", f"log_dir={tmp_path / 'jax'}"])
    j = j_ex.EXPERIMENTS["world_model_sweep"](cfg)
    assert seen == [16, 16]
    assert set(p) == set(j) == {"best_config", "best_metrics", "n_trials", "n_failed", "table"}
    assert p["n_trials"] == j["n_trials"] == 2 and p["n_failed"] == j["n_failed"] == 0
    assert [set(r) for r in p["table"]] == [set(r) for r in j["table"]]
    assert [t["config"] for t in _trials(tmp_path / "port" / "wm_sweep")] == \
        [t["config"] for t in _trials(tmp_path / "jax" / "wm_sweep")] == \
        [{"z": 64, "rnn": "lstm", "loss": "mse"}, {"z": 64, "rnn": "gru", "loss": "mse"}]
    for row in p["table"]:
        assert np.isfinite(row["val_loss"]) and np.isfinite(row["val_recon_loss"])
    assert p["best_config"] in [{k: r[k] for k in ("z", "rnn", "loss")} for r in p["table"]]
    for rnn in ("lstm", "gru"):
        assert (tmp_path / "port" / f"world_model_{rnn}_16_mse" / "ckpt").is_dir()


def test_continuous_ab_harness_tiny(tmp_path):
    """The harness at a toy size on the CPU writes every tier of one seed."""
    spec = importlib.util.spec_from_file_location(
        "continuous_ab_torch", ROOT / "benchmarks_torch" / "continuous_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    out = tmp_path / "ab.json"
    result = ab.main(["--device", "cpu", "--envs", "2", "--steps", "5", "--collect-envs", "2",
                      "--collect-steps", "10", "--epochs", "1", "--batch", "8",
                      "--out", str(out)])
    report = json.loads(out.read_text())
    assert report["summary"] == result["summary"] and "wall_seconds" in report
    run = report["runs"]["0"]
    for tier in ("expert", "bc_discrete", "bc_continuous", "dagger_discrete",
                 "dagger_continuous"):
        assert np.isfinite(run[tier]["driving_score"]), tier
        assert report["summary"][tier]["driving_score"]["values"] == [run[tier]["driving_score"]]
        assert report[tier] == run[tier]
    assert run["expert"]["action_agreement"] == 1.0 and run["dataset_frames"] == 20
    assert set(run["bc_continuous_final"]) >= {"loss", "steer_mae", "accel_mae"}
    assert set(run["bc_discrete_final"]) == {"loss", "accuracy"}


@pytest.mark.parametrize("name", ["hpo", "hpo_vmap", "hpo_pbt", "world_model_sweep"])
def test_presets_equal_jax(name):
    from carla_imitation_learning_tpu_torch.config import compose as p_compose

    j = j_compose("config", overrides=[f"experiment={name}"])
    p = p_compose("config", overrides=[f"experiment={name}"])
    keys = {"experiment_name", "num_samples", "population", "generations", "n_envs", "n_steps"}
    assert {k: j.get(k) for k in keys} == {k: p.get(k) for k in keys}
    assert p["experiment_name"] == name

"""The sequence, world-model and ViT experiments of the PyTorch port through
``cli.main run`` at toy size on the CPU (plain versions): ``bc_rnn``,
``world_model`` (LSTM with MSE, GRU with MS-SSIM), ``world_model_imagine``,
``dream_policy`` (discrete, and continuous with a single reward head and
no anchor), and ``bc -o experiment=bc_vit`` followed by
``closed_loop_eval`` of its checkpoint at 64², where the ViT's 16² position
grid is resized down to 4². Each run uses its preset with epochs, updates,
steps and widths cut; the checks are the JAX experiments' result keys and
finite, in-range values. The quality harness's ``--arch vit`` and
``--balanced`` run at a toy size."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from carla_imitation_learning_tpu_torch import cli
from test_torch_experiments import TINY

ROOT = Path(__file__).resolve().parents[1]
TOY = ["device=cpu", "compute_dtype=float32", "n_envs=2", "n_steps=24", "NUM_EPOCHS=1",
       "eval_envs=2", "eval_steps=4"]


def _run(capsys, tmp_path, preset: str, *overrides, checkpoint=None):
    args = ["run", "-o", f"experiment={preset}", "-o", f"data_dir={tmp_path / 'data'}",
            "-o", f"log_dir={tmp_path / 'logs'}", "--json"]
    for o in (*TINY, *TOY, *overrides):
        args += ["-o", o]
    if checkpoint:
        args += ["--checkpoint", checkpoint]
    assert cli.main(args) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _score_ok(metrics: dict, steps: int) -> None:
    assert metrics["env_steps"] == steps and 0.0 <= metrics["driving_score"] <= 1.0


def test_bc_rnn(tmp_path, capsys):
    res = _run(capsys, tmp_path, "bc_rnn", "seq_len=4", "BATCH_SIZE=4", "rnn_hidden=16")
    assert np.isfinite(res["history"][-1]["train_loss"])
    assert np.isfinite(res["test"]["test_loss"]) and 0 <= res["test"]["test_accuracy"] <= 1
    assert Path(res["best_path"], "checkpoint.pt").is_file()
    _score_ok(res["closed_loop"], 8)


@pytest.mark.parametrize("rnn,loss", [("lstm", "mse"), ("gru", "ms_ssim")])
def test_world_model(tmp_path, capsys, rnn, loss):
    res = _run(capsys, tmp_path, "world_model", f"wm_rnn={rnn}", f"wm_image_loss={loss}",
               "wm_z_size=16", "wm_batch=4")
    row = res["history"][-1]
    for k in ("loss", "recon_loss", "latent_pred_loss", "image_pred_loss"):
        assert np.isfinite(row[f"train_{k}"]) and np.isfinite(row[f"val_{k}"]), k
    assert res["wm_config"] == {"z_size": 16, "rnn": rnn, "n_actions": 9, "height": 64,
                                "width": 64, "image_loss": loss, "seq_len": 8}
    assert res["test"] == {}


def test_world_model_imagine(tmp_path, capsys):
    res = _run(capsys, tmp_path, "world_model_imagine", "horizon=3", "wm_z_size=16",
               "wm_batch=4")
    assert res["horizon"] == 3 and len(res["mse_per_step"]) == len(res["ssim_per_step"]) == 3
    assert all(0 <= v <= 1 for v in res["mse_per_step"])
    assert all(-1 <= v <= 1 for v in res["ssim_per_step"])
    assert np.isfinite(res["train_val_loss"]) and Path(res["strip_path"]).is_file()


@pytest.mark.parametrize("family", ["discrete", "continuous"])
def test_dream_policy(tmp_path, capsys, family):
    extra = (["policy_family=continuous", "reward_ensemble=1", "imag_bc_anchor=0"]
             if family == "continuous" else ["reward_ensemble=2"])
    res = _run(capsys, tmp_path, "dream_policy", "imag_updates=3", "imag_batch=8",
               "reward_steps=3", "latent_bc_steps=3", "imag_horizon=3", "wm_z_size=16",
               "wm_batch=4", *extra)
    assert set(res) == {"wm_val_loss", "reward_head_mse", "imagination",
                        "imagined_return_first", "imagined_return_last", "eval", "expert",
                        "mitigations", "latent_bc_loss", "latent_bc_eval"}
    assert len(res["reward_head_mse"]) == 3 and len(res["latent_bc_loss"]) == 3
    assert [h["update"] for h in res["imagination"]] == [0, 1, 2]
    assert set(res["imagination"][0]) == {"update", "imagined_return", "entropy", "anchor_kl",
                                          "reward_std", "alive_frac", "loss"}
    assert res["mitigations"]["reward_ensemble"] == (1 if family == "continuous" else 2)
    for who in ("eval", "expert", "latent_bc_eval"):
        _score_ok(res[who], 8)
    assert res["expert"]["action_agreement"] == 1.0


def test_bc_vit_then_closed_loop_eval(tmp_path, capsys):
    res = _run(capsys, tmp_path, "bc_vit", "vit_dim=32", "vit_depth=1", "vit_heads=2",
               "image_height=64", "image_width=64", "BATCH_SIZE=4", "synthetic_frames=80")
    best = res["camera"]["best_path"]
    assert np.isfinite(res["camera"]["test"]["test_loss"])
    ev = _run(capsys, tmp_path, "closed_loop_eval", "policy_arch=vit", "vit_dim=32",
              "vit_depth=1", "vit_heads=2", "n_steps=4", checkpoint=best)
    for who in ("policy", "expert"):
        _score_ok(ev[who], 8)


@pytest.mark.parametrize("option", [["--arch", "vit"], ["--balanced"]], ids=["vit", "balanced"])
def test_driving_quality_options_tiny(tmp_path, option):
    """``benchmarks_torch/driving_quality.py --arch vit`` and ``--balanced``
    at a toy size on the CPU write the expert, untrained and BC rungs."""
    spec = importlib.util.spec_from_file_location(
        "driving_quality_torch", ROOT / "benchmarks_torch" / "driving_quality.py")
    dq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dq)
    out = tmp_path / "dq.json"
    dq.main(["--device", "cpu", "--envs", "2", "--steps", "6", "--collect-envs", "2",
             "--collect-steps", "10", "--epochs", "1", "--batch", "8", "--dagger", "0",
             "--out", str(out), *option])
    report = json.loads(out.read_text())
    run = report["runs"]["0"]
    for tier in ("expert", "untrained", "bc"):
        assert np.isfinite(run[tier]["driving_score"]), tier
    assert report["config"]["arch"] == ("vit" if "vit" in option else "cnn")
    assert report["config"]["balanced"] == ("--balanced" in option)
    assert run["train_steps"] == 1 and np.isfinite(run["bc_final_loss"])
    if "vit" in option:
        with pytest.raises(SystemExit, match="vit"):
            dq.main(["--device", "cpu", "--rl", "1", "--out", str(tmp_path / "x.json"),
                     *option])

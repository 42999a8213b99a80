"""The port's training harnesses: ``reference_control`` (the reference's
decode against the JAX harness's own, bit for bit, on frames the port's
``write_synthetic_log`` wrote, and its labels), ``vit_ab`` (its FLOP count
of a tiny CNN and ViT train step against an analytic count of their
convolutions and products) and ``vit_crossover`` (the epoch and budget
rule on a fake clock), and each one's ``main`` at a toy size on the CPU.

The JAX harness ``benchmarks/reference_control.py`` is loaded by path: it
imports only numpy at its top, and its ``_init_worker`` /
``_decode_window`` run in this process.
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
HARNESSES = ROOT / "benchmarks_torch"


def _load_by_path(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _harness(name: str):
    """A port harness imported under its own name, so that worker processes
    started by ``spawn`` can import the functions they are handed."""
    if str(HARNESSES) not in sys.path:
        sys.path.insert(0, str(HARNESSES))
    return importlib.import_module(name)


reference_control = _harness("reference_control")
vit_ab = _load_by_path("vit_ab_torch_harness", HARNESSES / "vit_ab.py")
vit_crossover = _load_by_path("vit_crossover_torch_harness", HARNESSES / "vit_crossover.py")
jax_reference_control = _load_by_path("reference_control_jax_harness",
                                      ROOT / "benchmarks" / "reference_control.py")


# --- reference_control ------------------------------------------------------

@pytest.fixture(scope="module", params=["png", "jpeg"])
def synthetic_log(request, tmp_path_factory):
    from carla_imitation_learning_tpu_torch.data import frame_log as fl

    root = tmp_path_factory.mktemp(f"log_{request.param}")
    fl.write_synthetic_log(root, log="Log1", cameras=("camera",), n_frames=12, height=40,
                           width=48, image_format=request.param)
    return root


def test_decode_window_matches_jax(synthetic_log):
    cam_dir = str(synthetic_log / "raw" / "Log1" / "camera")
    reference_control._init_worker(cam_dir)
    jax_reference_control._init_worker(cam_dir)
    for start in (0, 3, 8):
        got = reference_control._decode_window(start)
        want = jax_reference_control._decode_window(start)
        assert got.dtype == want.dtype == np.float32 and got.shape == (4, 40, 48)
        np.testing.assert_array_equal(got, want)


def test_labels_match_jax(synthetic_log):
    import jax.numpy as jnp

    from carla_imitation_learning_tpu.data import frame_log as j_fl
    from carla_imitation_learning_tpu.data.actions import continuous_to_discrete
    from carla_imitation_learning_tpu_torch.data import frame_log as p_fl

    j_log = j_fl.load_state_csv(synthetic_log / "raw" / "state.csv")
    want = np.asarray(continuous_to_discrete(jnp.asarray(j_log.steer),
                                             jnp.asarray(j_log.throttle),
                                             jnp.asarray(j_log.brake))).astype(np.int32)
    got = reference_control.window_labels(p_fl.load_state_csv(
        synthetic_log / "raw" / "state.csv"))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_reference_control_main_toy(tmp_path):
    """Two spawned workers, 24 JPEG frames at 32², batches of 4."""
    out = tmp_path / "rc.json"
    res = reference_control.main(["--device", "cpu", "--frames", "24", "--hw", "32",
                                  "--batch", "4", "--workers", "2",
                                  "--data-dir", str(tmp_path / "data"), "--out", str(out)])
    saved = json.loads(out.read_text())
    assert set(saved) >= {"metric", "value", "unit", "decode_only_images_per_sec", "config",
                          "device"}
    assert saved["config"] == {"frames": 24, "hw": 32, "batch": 4, "workers": 2,
                               "format": "jpeg",
                               "decoder": "PIL (faster than reference's skimage)"}
    assert res["value"] > 0 and res["decode_only_images_per_sec"] > 0
    assert len(list((tmp_path / "data" / "raw" / "Log1" / "camera").glob("*.jpeg"))) == 24


# --- vit_ab -----------------------------------------------------------------

def _conv_out(size: int, k: int, s: int) -> tuple[int, int]:
    """(output size, padded) of one conv of the trunk: VALID, or SAME where
    the map is smaller than the kernel."""
    if size < k:
        return -(-size // s), True
    return (size - k) // s + 1, False


def _cnn_forward_flops(batch: int, hw: int) -> tuple[int, int]:
    """(forward FLOPs, the first conv's) of ``PolicyCNN`` at ``hw``²:
    2 · output elements · C_in · k² per conv, 2 · in · out per dense row."""
    from carla_imitation_learning_tpu_torch.models import cnn

    total, first, size, c_in = 0, 0, hw, 4
    for i, (c_out, k, s, pool) in enumerate(zip(cnn.CHANNELS, cnn.KERNELS, cnn.STRIDES,
                                                cnn.POOLS)):
        size, _ = _conv_out(size, k, s)
        flops = 2 * batch * c_out * c_in * k * k * size * size
        total += flops
        first = first or flops
        if size >= pool:
            size //= pool
        c_in = c_out
    dims = (128, 64, 32, 9)
    total += sum(2 * batch * a * b for a, b in zip(dims, dims[1:]))
    return total, first


def _vit_forward_flops(batch: int, hw: int, dim: int, depth: int, patch: int = 16,
                       mlp: int = 4, n_actions: int = 9) -> tuple[int, int]:
    """(forward FLOPs, the patch embedding's) of ``ViTPolicy``: the patch
    conv, four projections, two MLP products and two attention products per
    block (2 · n² · dim each), and the head."""
    n = (hw // patch) ** 2
    embed = 2 * batch * dim * 4 * patch * patch * n
    block = (4 * 2 * n * dim * dim + 2 * 2 * n * dim * mlp * dim + 2 * 2 * n * n * dim)
    return embed + depth * batch * block + 2 * batch * dim * n_actions, embed


@pytest.mark.parametrize("arch", ["cnn", "vit"])
def test_step_flops_analytic(arch):
    """One train step counts three forwards (the backward's input and weight
    products), less the first layer's input gradient, which no step forms
    (the observation takes no gradient)."""
    from carla_imitation_learning_tpu_torch.models import PolicyCNN, ViTPolicy

    batch, hw = 2, 64
    if arch == "cnn":
        model = PolicyCNN(dtype=torch.float32)
        fwd, first = _cnn_forward_flops(batch, hw)
    else:
        model = ViTPolicy(dim=32, depth=2, heads=2, dtype=torch.float32)
        fwd, first = _vit_forward_flops(batch, hw, 32, 2)
    got = vit_ab.step_flops(model, batch, hw, torch.device("cpu"))
    assert got == 3 * fwd - first
    assert all(p.grad is None for p in model.parameters())


def test_vit_ab_main_toy(tmp_path, monkeypatch):
    monkeypatch.setattr(vit_ab, "bench_arch", functools.partial(
        vit_ab.bench_arch, short=1, long=2, reps=1))
    out = tmp_path / "va.json"
    res = vit_ab.main(["--device", "cpu", "--batch", "2", "--hw", "32", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["peak_tflops"] == vit_ab.H100_BF16_DENSE_TFLOPS == 989.0
    assert saved["flop_count"] == vit_ab.FLOP_COUNT
    for arch in ("cnn", "vit"):
        assert set(saved[arch]) == {"images_per_sec", "ms_per_step", "gflops_per_step",
                                    "mfu_pct", "params"}
        assert saved[arch]["gflops_per_step"] > 0
    assert res["vit"]["params"] > res["cnn"]["params"]


# --- vit_crossover ------------------------------------------------------------

class FakeClock:
    """Each epoch advances the clock by ``epoch_s``."""

    def __init__(self, epoch_s: float):
        self.now, self.epoch_s, self.epochs = 0.0, epoch_s, 0

    def __call__(self):
        return self.now

    def epoch(self):
        self.epochs += 1
        self.now += self.epoch_s


@pytest.mark.parametrize("epochs, epoch_s, want", [
    (8, 1.0, (8, 7.0)),     # the budget-setting run: its wall after epoch 1
    (1, 1.0, (1, 0.0)),
    (3, 0.5, (3, 1.0)),
])
def test_train_until_fixed_epochs(epochs, epoch_s, want):
    clock = FakeClock(epoch_s)
    assert vit_crossover.train_until(clock.epoch, None, epochs, clock=clock) == want
    assert clock.epochs == want[0]


@pytest.mark.parametrize("budget, epoch_s, want_epochs", [
    (7.0, 1.0, 8),          # as many epochs as the CNN's when equally fast
    (7.0, 2.5, 4),          # slower epochs: fewer, the last one crossing the budget
    (0.1, 3.0, 2),          # at least the warm epoch and one timed epoch
    (1000.0, 1.0, 64),      # at most 64
])
def test_train_until_budget(budget, epoch_s, want_epochs):
    clock = FakeClock(epoch_s)
    done, wall = vit_crossover.train_until(clock.epoch, budget, 8, clock=clock)
    assert done == want_epochs == clock.epochs
    assert wall == pytest.approx((done - 1) * epoch_s)
    assert wall >= budget or done == vit_crossover.MAX_EPOCHS


def test_vit_crossover_main_toy(tmp_path):
    out = tmp_path / "vc.json"
    res = vit_crossover.main([
        "--device", "cpu", "--obs-hw", "32", "--envs", "2", "--steps", "3",
        "--collect-envs", "2", "--collect-steps", "16", "--epochs", "2", "--batch", "4",
        "--vit-dim", "16", "--vit-depth", "1", "--vit-heads", "2", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["dataset_frames"] == 32
    assert saved["reduced"] == {"collect_steps": {"default": 500, "run": 16},
                                "epochs": {"default": 8, "run": 2},
                                "steps": {"default": 300, "run": 3}}
    for tier in ("cnn", "vit_2m", "vit_scaled"):
        assert set(saved[tier]) == {"params", "epochs", "train_steps",
                                    "train_seconds_post_compile", "final_loss",
                                    "final_accuracy", "eval"}
        assert set(saved[tier]["eval"]) == set(vit_crossover.KEEP)
        assert np.isfinite(saved[tier]["final_loss"])
    assert saved["cnn"]["epochs"] == 2 and saved["vit_2m"]["epochs"] >= 2
    assert saved["wall_budget_seconds"] == res["cnn"]["train_seconds_post_compile"]
    assert set(saved["expert"]) == set(vit_crossover.KEEP)

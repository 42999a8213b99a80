"""A whole ``bc`` run of the port against the JAX package's on one
synthetic 64² log (120 frames, 2 epochs, batch 8, fp32), both started
from the same JAX initial state carried across as a checkpoint
(``resume_checkpoint``; the port's through ``convert.checkpoint_from_jax``):
per-epoch metrics at rtol 1e-4 (the ``Trainer.fit`` tolerance of
``tests/test_torch_training.py``), the same best-k steps and the same test
accuracy. Then ``test_eval`` and the ``stats`` functions of both packages
on JAX's best checkpoint: the same predictions and accuracies."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu import experiments as j_ex
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu.data import stats as j_stats
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu.training import steps as j_steps
from carla_imitation_learning_tpu.utils import checkpoint as j_ckpt
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch import experiments as p_ex
from carla_imitation_learning_tpu_torch.config import compose as p_compose
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe
from carla_imitation_learning_tpu_torch.data import stats as p_stats
from carla_imitation_learning_tpu_torch.models import PolicyCNN
from carla_imitation_learning_tpu_torch.utils import checkpoint as p_ckpt

HW = 64


def _overrides(root, pkg, *extra):
    return ["model=imitation", f"data_dir={root / 'data'}", f"log_dir={root / pkg}",
            f"image_height={HW}", f"image_width={HW}", "NUM_EPOCHS=2", "BATCH_SIZE=8",
            "bc_cameras=['camera']", "compute_dtype=float32",
            "trainer.checkpoint.save_top_k=2", "trainer.num_sanity_val_steps=1", *extra]


def _raw(path):
    return ocp.StandardCheckpointer().restore(Path(path).resolve())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``bc`` on one store, the JAX run first (it writes the
    synthetic log)."""
    root = tmp_path_factory.mktemp("bc")
    j_ex._maybe_synthesize(j_compose("config", overrides=_overrides(root, "jax")))
    jcfg = j_compose("config", overrides=_overrides(root, "jax"))
    spe = len(j_pipe.sequential_train_val_test_iterator(jcfg)["train_dataloader"])
    model = JPolicyCNN(dtype=jnp.float32)
    init = j_steps.create_train_state(
        model, jax.random.PRNGKey(21), model.example_input(1, HW, HW),
        j_steps.make_optimizer(jcfg, steps_per_epoch=spe))
    j_ckpt.save_pytree(root / "init_jax", {"params": init.params,
                                           "opt_state": init.opt_state, "step": init.step})
    p_ckpt.save_pytree(root / "init_port", convert.checkpoint_from_jax(_raw(root / "init_jax")))
    jres = j_ex.EXPERIMENTS["bc"](j_compose("config", overrides=_overrides(
        root, "jax", f"resume_checkpoint={root / 'init_jax'}")))["camera"]
    pres = p_ex.EXPERIMENTS["bc"](p_compose("config", overrides=_overrides(
        root, "port", f"resume_checkpoint={root / 'init_port'}", "device=cpu")))["camera"]
    return root, jres, pres


def test_bc_history_matches_jax(runs):
    _, jres, pres = runs
    assert len(pres["history"]) == len(jres["history"]) == 2
    for prow, jrow in zip(pres["history"], jres["history"]):
        assert set(prow) == set(jrow)
        for k in jrow:
            np.testing.assert_allclose(prow[k], jrow[k], rtol=1e-4, err_msg=k)
    for k, v in jres["test"].items():
        np.testing.assert_allclose(pres["test"][k], float(v), rtol=1e-4, err_msg=k)
    assert pres["test"]["test_accuracy"] == pytest.approx(float(jres["test"]["test_accuracy"]),
                                                          abs=0)


def test_bc_keeps_the_same_best_k(runs):
    root, jres, pres = runs

    def steps_of(pkg):
        index = root / pkg / "imitation_camera" / "ckpt" / "index.json"
        return [e["step"] for e in json.loads(index.read_text())]

    assert steps_of("port") == steps_of("jax") and len(steps_of("port")) == 2
    assert Path(pres["best_path"]).name == Path(jres["best_path"]).name
    np.testing.assert_allclose(pres["best_metric"], jres["best_metric"], rtol=1e-4)
    for pkg in ("port", "jax"):
        logged = [json.loads(line) for line in
                  (root / pkg / "imitation_camera" / "metrics.jsonl").read_text().splitlines()]
        assert [r["step"] for r in logged if "val_loss" in r] == [0, 1]


def test_best_checkpoint_restores_the_trained_logits(runs):
    """The port's best checkpoint against JAX's best one (converted): fp32
    logits at rtol 1e-4 on a val batch."""
    root, jres, pres = runs
    jraw = _raw(jres["best_path"])
    port = PolicyCNN(dtype=torch.float32)
    port.load_state_dict(p_ckpt.restore_params(pres["best_path"], port.state_dict()))
    x = p_pipe.FrameStore.from_processed_dir(p_compose("config", overrides=_overrides(
        root, "port")), "val").frames[:8, :, :, None].repeat(4, -1) / 255.0
    want = np.asarray(JPolicyCNN(dtype=jnp.float32).apply({"params": jraw["params"]},
                                                          jnp.asarray(x, jnp.float32)))
    with torch.no_grad():
        got = port(torch.from_numpy(x.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_test_eval_and_stats_match_jax(runs):
    """``test_eval`` on JAX's best checkpoint (converted for the port): the
    same accuracies on every split and the same predictions dump; the
    ``stats`` functions agree on those predictions."""
    root, jres, _ = runs
    p_ckpt.save_pytree(root / "best_port", convert.checkpoint_from_jax(_raw(jres["best_path"])))
    jcfg = j_compose("config", overrides=_overrides(root, "jax_eval"))
    pcfg = p_compose("config", overrides=_overrides(root, "port_eval", "device=cpu"))
    jout = j_ex.EXPERIMENTS["test_eval"](jcfg, checkpoint=jres["best_path"])
    pout = p_ex.EXPERIMENTS["test_eval"](pcfg, checkpoint=str(root / "best_port"))
    assert pout["accuracy"] == pytest.approx(jout["accuracy"], abs=0)
    jdump = np.load(jout["predictions_file"], allow_pickle=True).item()
    pdump = np.load(pout["predictions_file"], allow_pickle=True).item()
    for k in ("predicted", "labels"):
        np.testing.assert_array_equal(pdump[k], jdump[k], err_msg=k)
    assert Path(pout["sample_output_plot"]).stat().st_size > 0

    labels, preds = pdump["labels"], pdump["predicted"]
    np.testing.assert_array_equal(p_stats.confusion_matrix(labels, preds, 9),
                                  j_stats.confusion_matrix(labels, preds, 9))
    for a, b in zip(p_stats.per_class_prf(labels, preds, 9),
                    j_stats.per_class_prf(labels, preds, 9)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    rl, rp = rng.integers(0, 9, 200), rng.integers(0, 9, 200)
    np.testing.assert_array_equal(p_stats.action_histogram(rl), j_stats.action_histogram(rl))
    for a, b in zip(p_stats.per_class_prf(rl, rp, 9), j_stats.per_class_prf(rl, rp, 9)):
        np.testing.assert_array_equal(a, b)

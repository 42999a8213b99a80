"""Whole runs of the aux experiment, the port's against the JAX
package's, fp32 on the CPU at 32², both started from one initial state
(drawn with numpy, saved in the JAX package's form) carried across as a
checkpoint (``resume_checkpoint``; the port's through
``convert.checkpoint_from_jax``): per-epoch metrics and the test metrics
at rtol 1e-4, as ``tests/test_torch_bc_run.py`` holds ``bc``:

- ``bc_aux`` on a synthetic log (file path, fused epochs);
- ``bc_aux -o aux_seg_weight=0.5``, both packages' collection replaced by
  one synthetic store and class plane (the collections draw from
  different generators), speed dropout on: the port's run then drives its
  closed loop with the trained AuxNet;
- ``cli list`` names the new experiments."""

import contextlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu import experiments as j_ex
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu.models import AuxNet as JAux
from carla_imitation_learning_tpu.training import closed_loop as j_cl
from carla_imitation_learning_tpu.training import steps as j_steps
from carla_imitation_learning_tpu.utils import checkpoint as j_ckpt
from carla_imitation_learning_tpu_torch import cli, convert
from carla_imitation_learning_tpu_torch import experiments as p_ex
from carla_imitation_learning_tpu_torch.config import compose as p_compose
from carla_imitation_learning_tpu_torch.data import pipeline as p_pipe
from carla_imitation_learning_tpu_torch.training import closed_loop as p_cl
from carla_imitation_learning_tpu_torch.utils import checkpoint as p_ckpt
from test_torch_aux import numpy_params

HW = 32
TINY = ["sim.n_agents=2", "sim.town.blocks=2", "sim.town.n_buildings=4", "render.height=32",
        "render.width=32", "render.max_triangles=256"]


def _overrides(root, pkg, *extra):
    return ["model=imitation", f"data_dir={root / 'data'}", f"log_dir={root / pkg}",
            f"image_height={HW}", f"image_width={HW}", "NUM_EPOCHS=2", "BATCH_SIZE=8",
            "synthetic_frames=60", "compute_dtype=float32", *extra]


def template_train_state(model, rng, example, tx, ema_decay: float = 0.0, params=None):
    """The JAX package's ``create_train_state`` without an init: ``params``
    (zeros of the model's shapes by default), Adam's state for them. The
    experiments restore ``resume_checkpoint`` over it, and an init (eager
    flax compiles op by op) would cost most of a small run's time."""
    if params is None:
        shapes = jax.eval_shape(model.init, rng, *example)["params"]
        params = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    return j_steps.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), apply_fn=model.apply, tx=tx,
                              ema_params=params if ema_decay > 0.0 else None,
                              ema_decay=float(ema_decay))


@pytest.fixture(autouse=True)
def _template_jax_init(monkeypatch):
    monkeypatch.setattr(j_ex, "create_train_state", template_train_state)


def _init(root, name, model, example, jcfg, spe):
    """Save an initial state of ``model`` (weights drawn with numpy) in the
    JAX package's form and its port conversion → (jax path, port path)."""
    example = example if isinstance(example, tuple) else (example,)
    init = template_train_state(model, jax.random.PRNGKey(21), example,
                                j_steps.make_optimizer(jcfg, steps_per_epoch=spe),
                                params=numpy_params(model, example, seed=21))
    payload = {"params": init.params, "opt_state": init.opt_state, "step": init.step}
    j_ckpt.save_pytree(root / f"{name}_jax", payload)
    p_ckpt.save_pytree(root / f"{name}_port", convert.checkpoint_from_jax(payload))
    return root / f"{name}_jax", root / f"{name}_port"


def _run_both(root, experiment, name, model_fn, example_fn, loaders_fn, *extra):
    j_ex._maybe_synthesize(j_compose("config", overrides=_overrides(root, "jax", *extra)))
    jcfg = j_compose("config", overrides=_overrides(root, "jax", *extra))
    spe = len(loaders_fn(jcfg)["train_dataloader"])
    jpath, ppath = _init(root, name, model_fn(), example_fn(), jcfg, spe)
    jres = j_ex.EXPERIMENTS[experiment](j_compose("config", overrides=_overrides(
        root, "jax", f"resume_checkpoint={jpath}", *extra)))
    pres = p_ex.EXPERIMENTS[experiment](p_compose("config", overrides=_overrides(
        root, "port", f"resume_checkpoint={ppath}", "device=cpu", *extra)))
    return jres, pres


def _same_history(pres, jres, epochs=2, kl_beta=None):
    """Per-epoch and test metrics at rtol 1e-4, the same best checkpoint.
    With ``kl_beta`` (the VAE's KL weight) a KL metric is held to its
    share of its row's loss tolerance: atol 1e-4 · loss / beta."""
    assert len(pres["history"]) == len(jres["history"]) == epochs
    rows = list(zip(pres["history"], jres["history"])) + [(pres["test"], jres["test"])]
    for prow, jrow in rows:
        assert set(prow) == set(jrow)
        for k in jrow:
            atol = 0.0
            if kl_beta is not None and k.endswith("kl_loss"):
                atol = 1e-4 * abs(float(jrow[k.replace("kl_loss", "loss")])) / kl_beta
            np.testing.assert_allclose(prow[k], float(jrow[k]), rtol=1e-4, atol=atol,
                                       err_msg=k)
    assert Path(pres["best_path"]).name == Path(jres["best_path"]).name


def test_bc_aux_run_matches_jax(tmp_path):
    jres, pres = _run_both(
        tmp_path, "bc_aux", "aux",
        lambda: JAux(image_hw=HW, dtype=jnp.float32),
        lambda: (JAux(image_hw=HW).example_input(1),),
        lambda cfg: j_pipe.sequential_aux_train_val_test_iterator(cfg),
        "aux_recon_weight=0.5", "aux_traffic_weight=0.2")
    _same_history(pres["camera"], jres["camera"])
    assert "train_image_recons_loss" in pres["camera"]["history"][0]


def _synthetic_collection(n_envs=2, n_steps=40, hw=32, seed=3):
    """An env-major store with episode starts and a (T, B, H, W) class
    plane, as ``collect_dataset`` would hand them out."""
    base = j_pipe.FrameStore.synthetic(n=n_envs * n_steps, height=hw, width=hw, seed=seed)
    starts = np.zeros(len(base), bool)
    starts[::n_steps] = True
    starts[17] = True
    base.starts = starts
    sem = np.random.default_rng(seed).integers(0, 8, (n_steps, n_envs, hw, hw)).astype(np.uint8)
    sem[:, :, hw // 2:] = 1                # a dominant class, as the road is
    return base, sem


def test_bc_aux_seg_run_matches_jax(tmp_path):
    extra = [*TINY, "aux_seg_weight=0.5", "n_envs=2", "n_steps=40", "eval_envs=2",
             "eval_steps=6"]
    base, sem = _synthetic_collection()
    pstore = p_pipe.FrameStore(frames=base.frames, actions=base.actions, traffic=base.traffic,
                               sensors=base.sensors, starts=base.starts)
    jcfg = j_compose("config", overrides=_overrides(tmp_path, "jax", *extra))
    jmodel = JAux(obs_size=4, image_hw=32, seg_classes=8, dtype=jnp.float32)
    jpath, ppath = _init(tmp_path, "seg", jmodel, (jmodel.example_input(1),), jcfg, 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_cl, "collect_dataset", lambda *a, **k: (base, None, {"semantic": sem}))
        mp.setattr(j_cl, "evaluate_policy", lambda *a, **k: {})
        jres = j_ex.EXPERIMENTS["bc_aux"](j_compose("config", overrides=_overrides(
            tmp_path, "jax", f"resume_checkpoint={jpath}", *extra)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_cl, "collect_dataset",
                   lambda *a, **k: (pstore, None, {"semantic": torch.from_numpy(sem)}))
        pres = p_ex.EXPERIMENTS["bc_aux"](p_compose("config", overrides=_overrides(
            tmp_path, "port", f"resume_checkpoint={ppath}", "device=cpu", *extra)))
    _same_history(pres, jres)
    assert pres["seg_miou_test"] == pytest.approx(float(jres["seg_miou_test"]), rel=1e-4)
    assert 0.0 < pres["seg_miou_test"] <= 1.0
    assert pres["eval"]["env_steps"] == 12 and 0.0 <= pres["eval"]["driving_score"] <= 1.0
    assert "state" not in pres


def test_cli_lists_the_new_experiments():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["list"]) == 0
    names = {line.split()[0] for line in out.getvalue().splitlines()}
    assert {"bc_aux", "bc_raw_segment", "vae_pooled", "vae_leave_one_out"} <= names

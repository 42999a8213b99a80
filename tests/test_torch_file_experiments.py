"""Whole runs of the file-backed experiments ``vae_pooled``,
``vae_leave_one_out`` and ``bc -o augment=true``, the port's against the
JAX package's, fp32 on the CPU at 32², both started from one initial
state (drawn with numpy) carried across as a checkpoint: per-epoch
metrics and test metrics at rtol 1e-4. The VAE's KL metric is held to the
share of its row's loss tolerance that it carries, atol 1e-4 · loss /
beta (the loss is alpha · MSE + beta · KL): Adam moves weights with
near-zero gradients by up to a whole step on reduction-order rounding
(ROADMAP Queue 3, "Adam and near-zero gradients"), parameters drift by
≈ 1e-5 after one step, and the KL of a near-prior posterior, a sum of
terms that cancel, shows it first (gaps of 1e-7 to 1.6e-5 on six
synthetic data sets, against bounds of about 3e-5). The port's train
steps draw from a torch generator; here its draw hooks
(``models.vae.draw_noise``, ``ops.augment.augment_draws``) are patched to
hand out the JAX package's draws, key by key as its trainer splits them
(one split per train step, none in evaluation)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu import experiments as j_ex
from carla_imitation_learning_tpu.data import pipeline as j_pipe
from carla_imitation_learning_tpu.data import vae_data as j_vae_data
from carla_imitation_learning_tpu.models import ConvVAE as JVAE
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicy
from carla_imitation_learning_tpu_torch import experiments as p_ex
from carla_imitation_learning_tpu_torch.config import compose as p_compose
from carla_imitation_learning_tpu_torch.models import vae as p_vae
from carla_imitation_learning_tpu_torch.ops import augment as p_aug
from test_torch_aux_experiments import _init, _same_history, template_train_state
from test_torch_dual_stream import jax_draws

HW = 32
SEED = 12345   # default_seeds.yaml's ``seed``: the key both trainers start from


@pytest.fixture(autouse=True)
def _template_jax_init(monkeypatch):
    monkeypatch.setattr(j_ex, "create_train_state", template_train_state)


class JaxKeys:
    """The JAX trainer's per-step keys: ``rng, k = split(rng)``."""

    def __init__(self, seed: int):
        self.rng = jax.random.PRNGKey(seed)
        self.calls = 0

    def __call__(self):
        self.rng, k = jax.random.split(self.rng)
        self.calls += 1
        return k


def _vae_overrides(root, pkg, *extra):
    """A batch of 6 does not divide the 8 virtual CPU devices of the test
    harness, so the JAX package builds no mesh (which would drop the
    VAE's partial train batch)."""
    return [f"data_dir={root / 'data'}", f"log_dir={root / pkg}", f"image_size=[1,{HW},{HW}]",
            "logs=['L1','L2']", "synthetic_frames=12", "NUM_EPOCHS=2", "BATCH_SIZE=6",
            "compute_dtype=float32", *extra]


@pytest.mark.parametrize("experiment,split", [("vae_pooled", "pooled_data"),
                                              ("vae_leave_one_out", "leave_one_out_data")])
def test_vae_run_matches_jax(tmp_path, monkeypatch, experiment, split):
    jcfg = j_compose("config", overrides=_vae_overrides(tmp_path, "jax"))
    cfg_c = jcfg.copy()
    cfg_c["camera"] = "SL"
    cfg_c["train_logs"] = jcfg["logs"] if split == "pooled_data" else jcfg["logs"][:-1]
    cfg_c["test_logs"] = jcfg["logs"][-1:]
    # the port's synthesis seeds each log by its name's CRC-32; the JAX
    # package's by ``hash``, which changes between processes
    p_ex._maybe_synthesize_vae(cfg_c)
    spe = len(j_vae_data.train_val_test_iterator(cfg_c, split)["train_dataloader"])
    model = JVAE(height=HW, width=HW, dtype=jnp.float32)
    jpath, ppath = _init(tmp_path, "vae", model, (model.example_input(1),), jcfg, spe)
    jres = j_ex.EXPERIMENTS[experiment](j_compose("config", overrides=_vae_overrides(
        tmp_path, "jax", f"resume_checkpoint={jpath}")))
    keys = JaxKeys(SEED)
    monkeypatch.setattr(p_vae, "draw_noise", lambda gen, shape, device, dtype: torch.from_numpy(
        np.asarray(jax.random.normal(keys(), shape, jnp.float32))))
    pres = p_ex.EXPERIMENTS[experiment](p_compose("config", overrides=_vae_overrides(
        tmp_path, "port", f"resume_checkpoint={ppath}", "device=cpu")))
    assert keys.calls == 2 * spe
    _same_history(pres, jres, kl_beta=float(jcfg["beta"]))
    assert {"train_recon_loss", "val_kl_loss"} <= set(pres["history"][0])


def test_bc_augmented_run_matches_jax(tmp_path, monkeypatch):
    overrides = ["model=imitation", f"data_dir={tmp_path / 'data'}", f"image_height={HW}",
                 f"image_width={HW}", "NUM_EPOCHS=2", "BATCH_SIZE=8", "synthetic_frames=60",
                 "compute_dtype=float32", "experiment=bc_augmented"]

    def cfg(compose, pkg, *extra):
        return compose("config", overrides=[*overrides, f"log_dir={tmp_path / pkg}", *extra])

    j_ex._maybe_synthesize(cfg(j_compose, "jax"))
    jcfg = cfg(j_compose, "jax")
    assert jcfg["augment"] is True and list(jcfg["bc_cameras"]) == ["camera"]
    spe = len(j_pipe.sequential_train_val_test_iterator(jcfg)["train_dataloader"])
    model = JPolicy(dtype=jnp.float32)
    jpath, ppath = _init(tmp_path, "bc", model, model.example_input(1, HW, HW), jcfg, spe)
    jres = j_ex.EXPERIMENTS["bc"](cfg(j_compose, "jax", f"resume_checkpoint={jpath}"))
    keys = JaxKeys(SEED)
    monkeypatch.setattr(p_aug, "augment_draws",
                        lambda gen, x, *a: jax_draws(keys(), x.numpy()))
    pres = p_ex.EXPERIMENTS["bc"](cfg(p_compose, "port", f"resume_checkpoint={ppath}",
                                      "device=cpu"))
    assert keys.calls == 2 * spe
    _same_history(pres["camera"], jres["camera"])
    assert Path(pres["camera"]["best_path"]).exists()

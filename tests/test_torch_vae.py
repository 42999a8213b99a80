"""The conv VAE of the PyTorch port vs the JAX package, fp32 on the CPU,
weights drawn with numpy and carried across with ``convert``:

- the forward on the 224² VALID chain at batch 2 and on the 64² SAME
  pyramid: recon, mu and log_var allclose (rtol 1e-5 / atol 1e-6) with
  the JAX draw of the noise fed in; ``representation`` and ``encode``;
- ``vae_loss_fn`` with the step's noise drawn by JAX (the port's
  ``draw_noise`` patched to it): loss and metrics at rtol 1e-5, gradients
  rtol 1e-4 / atol 1e-6; evaluation (no generator) uses z = mu;
- ``kl_divergence`` at rtol 1e-6;
- ``vae_data``: the pooled and leave-one-out splits and the
  ``ImageDataset`` batches equal the JAX package's, the frame tiers'
  order;
- ``flax_init_`` draws transposed-conv kernels with flax's fan-in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.data import vae_data as j_vae_data
from carla_imitation_learning_tpu.models import ConvVAE as JVAE
from carla_imitation_learning_tpu.training import losses as j_losses
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data import frame_log as p_fl
from carla_imitation_learning_tpu_torch.data import vae_data as p_vae_data
from carla_imitation_learning_tpu_torch.models import ConvVAE
from carla_imitation_learning_tpu_torch.models import vae as p_vae
from carla_imitation_learning_tpu_torch.native import save_framestore
from carla_imitation_learning_tpu_torch.data.pipeline import FrameStore
from carla_imitation_learning_tpu_torch.training import losses, steps
from test_torch_aux import numpy_params


def _pair(hw: int, seed: int = 0):
    jmodel = JVAE(height=hw, width=hw, dtype=jnp.float32)
    params = numpy_params(jmodel, (jmodel.example_input(1),), seed)
    model = convert.model_for_params(params, torch.float32)
    model.load_state_dict(convert.vae_state_dict(params))
    return jmodel, params, model


@pytest.mark.parametrize("hw", [224, 64])
def test_forward_matches(hw):
    jmodel, params, model = _pair(hw)
    assert isinstance(model, ConvVAE) and model.reference_chain == (hw == 224)
    assert model.hidden_size == jmodel.hidden_size == 2048
    x = np.random.default_rng(1).random((2, hw, hw, 1), np.float32)
    key = jax.random.PRNGKey(5)
    want = jmodel.apply({"params": params}, jnp.asarray(x), key)
    eps = np.asarray(jax.random.normal(key, (2, 32), jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(x), noise=torch.from_numpy(eps))
        rep = model.representation(torch.from_numpy(x))
    for name, g, w in zip(("recon", "mu", "log_var"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(rep.numpy(), np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(x), method=jmodel.representation)), rtol=1e-5,
        atol=1e-6)
    assert got[0].shape == (2, hw, hw, 1)


def test_loss_metrics_and_gradients_match(monkeypatch):
    jmodel, params, model = _pair(64, seed=2)
    x = np.random.default_rng(3).random((4, 64, 64, 1), np.float32)
    key = jax.random.PRNGKey(11)
    loss_j = j_losses.vae_loss_fn(0.75, 0.1)
    (j_loss, j_m), j_grads = jax.jit(jax.value_and_grad(
        lambda p: loss_j(p, jmodel.apply, jnp.asarray(x), key), has_aux=True))(params)
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (4, 32), jnp.float32)))
    monkeypatch.setattr(p_vae, "draw_noise", lambda gen, shape, device, dtype: eps)
    loss, metrics = losses.vae_loss_fn(0.75, 0.1)(model, torch.from_numpy(x),
                                                  torch.Generator())
    loss.backward()
    assert set(metrics) == set(j_m) == {"loss", "recon_loss", "kl_loss"}
    for k in j_m:
        np.testing.assert_allclose(float(metrics[k]), float(j_m[k]), rtol=1e-5, err_msg=k)
    want = convert.vae_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # evaluation: no generator, z = mu
    j_eval = loss_j(params, jmodel.apply, (jnp.asarray(x),), None)[1]
    with torch.no_grad():
        p_eval = losses.vae_loss_fn(0.75, 0.1)(model, (torch.from_numpy(x),))[1]
    for k in j_eval:
        np.testing.assert_allclose(float(p_eval[k]), float(j_eval[k]), rtol=1e-5, err_msg=k)


def test_kl_divergence_matches():
    rng = np.random.default_rng(6)
    mu, lv = rng.normal(size=(2, 5, 32)).astype(np.float32)
    want = float(j_losses.kl_divergence(jnp.asarray(mu), jnp.asarray(lv)))
    got = float(losses.kl_divergence(torch.from_numpy(mu), torch.from_numpy(lv)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _vae_cfg(tmp_path, **kw):
    cfg = {"data_dir": str(tmp_path), "image_size": [1, 32, 32], "train_logs": ["A", "B"],
           "test_logs": ["C"], "TEST_SIZE": 0.15, "VALID_SIZE": 0.2, "data_seed": 4,
           "BATCH_SIZE": 8, "seed": 2, "camera": ["SL", "FL"]}
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def vae_logs(tmp_path_factory):
    root = tmp_path_factory.mktemp("vae")
    for i, log in enumerate(("A", "B", "C")):
        p_fl.write_synthetic_log(root, log=log, cameras=("SL",), n_frames=20 + 7 * i,
                                 height=32, width=32, seed=i)
    return root


@pytest.mark.parametrize("split", ["pooled_data", "leave_one_out_data"])
def test_vae_splits_and_batches_match(vae_logs, split):
    cfg = _vae_cfg(vae_logs)
    get_j = {"pooled_data": j_vae_data.get_pooled_data,
             "leave_one_out_data": j_vae_data.get_leave_out_data}[split]
    get_p = {"pooled_data": p_vae_data.get_pooled_data,
             "leave_one_out_data": p_vae_data.get_leave_out_data}[split]
    jd, pd = get_j(cfg, "SL"), get_p(cfg, "SL")
    for k in ("train", "val", "test"):
        assert len(pd[k]) > 0
        np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
    jl = j_vae_data.train_val_test_iterator(cfg, split)
    pl = p_vae_data.train_val_test_iterator(cfg, split, device="cpu")
    for name in jl:
        assert len(pl[name]) == len(jl[name])
        for epoch in range(2):
            for jb, pb in zip(jl[name], pl[name]):
                assert pb.dtype == torch.float32 and pb.shape[-1] == 1
                np.testing.assert_array_equal(pb.numpy(), np.asarray(jb), err_msg=name)


def test_frame_tiers(tmp_path):
    """``<cam>_resized_<h>_bw`` wins over the packed ``<cam>.tpuilfs``,
    which wins over the raw folder."""
    p_fl.write_synthetic_log(tmp_path, log="A", cameras=("SL",), n_frames=6, height=32,
                             width=32, seed=0)
    raw = p_fl.FrameLog(tmp_path / "raw" / "A" / "SL").read_all_gray_u8()
    cfg = _vae_cfg(tmp_path, train_logs=["A"])
    np.testing.assert_array_equal(p_vae_data._load_frames(cfg, ["A"], "SL"), raw)
    packed = FrameStore.synthetic(n=5, height=32, width=32, seed=9)
    save_framestore(tmp_path / "raw" / "A" / "SL.tpuilfs", packed)
    np.testing.assert_array_equal(p_vae_data._load_frames(cfg, ["A"], "SL"), packed.frames)
    p_fl.save_frames(tmp_path / "raw" / "A" / "SL_resized_32_bw", raw[:3])
    np.testing.assert_array_equal(p_vae_data._load_frames(cfg, ["A"], "SL"), raw[:3])
    np.testing.assert_array_equal(j_vae_data._load_frames(cfg, ["A"], "SL"), raw[:3])


def test_flax_init_draws_transposed_kernels():
    model = steps.flax_init_(ConvVAE(height=64, width=64, dtype=torch.float32),
                             torch.Generator().manual_seed(0))
    for deconv in model.decoder:
        w = deconv.weight.detach()
        fan_in = w.shape[0] * w.shape[2] * w.shape[3]
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
        assert float(w.abs().max()) <= 2 / np.sqrt(fan_in) / 0.8796 + 1e-6
        assert not deconv.bias.detach().any()

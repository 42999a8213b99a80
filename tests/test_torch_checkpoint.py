"""Checkpoints: the port's best-k manager keeps the JAX manager's steps and
``index.json`` on one score sequence with a NaN; ``save_last``;
``restore_params`` prefers the EMA shadow and refuses a wrong shape; an
Orbax checkpoint written by the JAX package, through
``convert.checkpoint_from_jax``, gives the JAX logits (fp32 allclose,
rtol 1e-5 / atol 1e-6) and continues its run (one Adam step, rtol 1e-4 /
atol 1e-5, the tolerance of ``tests/test_torch_training.py``); a port
checkpoint restores its own state's logits bit for bit."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu.training import losses as j_losses
from carla_imitation_learning_tpu.training import steps as j_steps
from carla_imitation_learning_tpu.utils import checkpoint as j_ckpt
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.models import PolicyCNN
from carla_imitation_learning_tpu_torch.training import losses, steps
from carla_imitation_learning_tpu_torch.utils import checkpoint as p_ckpt

HW, BATCH = 48, 6
SCORES = [3.0, 2.0, float("nan"), 2.5, 1.0, 1.5, 0.5]


def _entries(directory):
    index = json.loads((directory / "index.json").read_text())
    return [{**e, "path": e["path"].rsplit("/", 1)[1]} for e in index]


@pytest.mark.parametrize("mode,top_k", [("min", 2), ("max", 1), ("min", 3)])
def test_best_k_matches_jax(tmp_path, mode, top_k):
    """The same kept steps, index entries and directories for a NaN-bearing
    score sequence; ``save`` returns the path exactly when it keeps."""
    j_mgr = j_ckpt.BestKCheckpointManager(tmp_path / "jax", mode=mode, save_top_k=top_k,
                                          filename="run")
    p_mgr = p_ckpt.BestKCheckpointManager(tmp_path / "port", mode=mode, save_top_k=top_k,
                                          filename="run")
    for step, score in enumerate(SCORES):
        metrics = {"val_loss": score}
        jp = j_mgr.save(step, {"w": np.full(3, step, np.float32)}, metrics)
        pp = p_mgr.save(step, {"w": torch.full((3,), float(step))}, metrics)
        assert (jp is None) == (pp is None), step
        if pp is not None:
            assert pp.name == jp.name == f"run-step{step}"
    assert _entries(tmp_path / "port") == _entries(tmp_path / "jax")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert p_mgr.best["step"] == j_mgr.best["step"]
    best = p_mgr.restore()
    assert torch.equal(best["w"], torch.full((3,), float(p_mgr.best["step"])))
    assert not any(math.isnan(e["score"]) for e in p_mgr._index)


def test_index_reloads_and_save_last(tmp_path):
    """A new manager on the directory continues from ``index.json``;
    ``save_last`` rewrites ``<filename>-last`` on every call, kept or not."""
    mgr = p_ckpt.BestKCheckpointManager(tmp_path, save_top_k=1, save_last=True)
    mgr.save(0, {"w": torch.zeros(2)}, {"val_loss": 1.0})
    again = p_ckpt.BestKCheckpointManager(tmp_path, save_top_k=1, save_last=True)
    assert again.save(1, {"w": torch.ones(2)}, {"val_loss": 2.0}) is None
    assert again.best["step"] == 0 and (tmp_path / "ckpt-step0").is_dir()
    assert torch.equal(p_ckpt.restore_pytree(tmp_path / "ckpt-last")["w"], torch.ones(2))
    assert not (tmp_path / "ckpt-step1").exists()
    with pytest.raises(FileNotFoundError):
        p_ckpt.BestKCheckpointManager(tmp_path / "empty").restore()
    with pytest.raises(ValueError):
        p_ckpt.BestKCheckpointManager(tmp_path, mode="best")


def _port_state(seed=0, ema_decay=0.0):
    cfg = {"LEARNING_RATE": 1e-3, "LR_MILESTONES": [], "gradient_clip_val": 0.5}
    return steps.create_train_state(
        PolicyCNN(dtype=torch.float32), steps.make_optimizer(cfg),
        generator=torch.Generator().manual_seed(seed), ema_decay=ema_decay, device="cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((BATCH, HW, HW, 4)).astype(np.float32)
    y = rng.integers(0, 9, BATCH)
    return x, y


def test_restore_params_prefers_ema_and_checks_shapes(tmp_path):
    state = _port_state(ema_decay=0.5)
    x, y = _batch()
    steps.make_train_step(losses.bc_loss_fn)(state, (torch.from_numpy(x), torch.from_numpy(y)))
    p_ckpt.save_pytree(tmp_path / "full", state.payload())
    got = p_ckpt.restore_params(tmp_path / "full", state.model.state_dict())
    for k, v in state.ema.state_dict().items():
        assert torch.equal(got[k], v), k
    assert not torch.equal(got["head.layers.0.weight"],
                           state.model.state_dict()["head.layers.0.weight"])
    p_ckpt.save_pytree(tmp_path / "params", {"params": state.model.state_dict()})
    got = p_ckpt.restore_params(tmp_path / "params", state.model.state_dict())
    assert all(torch.equal(got[k], v) for k, v in state.model.state_dict().items())
    with pytest.raises(ValueError, match="shape"):
        p_ckpt.restore_params(tmp_path / "full", PolicyCNN(n_actions=5).state_dict())
    with pytest.raises(ValueError, match="keys"):
        p_ckpt.restore_params(tmp_path / "full", {"w": torch.zeros(1)})
    with pytest.raises(ValueError):
        p_ckpt.restore_pytree(tmp_path / "full", {"params": None})


def test_port_checkpoint_restores_bit_for_bit(tmp_path):
    """Saved by the manager, restored into a fresh model: the trained
    state's logits exactly; the payload resumes the optimizer and step."""
    state = _port_state(seed=1)
    step = steps.make_train_step(losses.bc_loss_fn)
    x, y = (torch.from_numpy(a) for a in _batch(1))
    for _ in range(2):
        step(state, (x, y))
    mgr = p_ckpt.BestKCheckpointManager(tmp_path, filename="imitation_camera")
    path = mgr.save(1, state.payload(), {"val_loss": 0.3})
    fresh = _port_state(seed=9)
    fresh.model.load_state_dict(p_ckpt.restore_params(path, fresh.model.state_dict()))
    with torch.no_grad():
        assert torch.equal(fresh.model(x), state.model(x))
    resumed = _port_state(seed=9)
    resumed.load_payload(p_ckpt.restore_pytree(path))
    assert resumed.step == 2
    step(state, (x, y))
    step(resumed, (x, y))
    for a, b in zip(state.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)


def test_jax_orbax_checkpoint_through_convert(tmp_path):
    """A JAX training checkpoint (clip + Adam, EMA) after two steps, saved
    by Orbax and restored without a template, converted and saved as a
    port checkpoint: ``restore_params`` gives JAX's EMA logits, and one more
    step from the restored payload gives JAX's next params."""
    cfg = j_compose("config", overrides=["model=imitation", "LR_MILESTONES=[]"])
    model = JPolicyCNN(dtype=jnp.float32)
    tx = j_steps.make_optimizer(cfg, steps_per_epoch=4)
    jstate = j_steps.create_train_state(model, jax.random.PRNGKey(3),
                                        jnp.zeros((1, HW, HW, 4)), tx, ema_decay=0.5)
    jstep = j_steps.make_train_step(j_losses.bc_loss_fn, donate=False)
    x, y = _batch(2)
    jbatch = (jnp.asarray(x), jnp.asarray(y, jnp.int32))
    for _ in range(2):
        jstate, _ = jstep(jstate, jbatch, jax.random.PRNGKey(0))
    j_ckpt.save_pytree(tmp_path / "jax", {
        "params": jstate.params, "opt_state": jstate.opt_state, "step": jstate.step,
        "ema_params": jstate.ema_params})
    raw = ocp.StandardCheckpointer().restore((tmp_path / "jax").resolve())
    payload = convert.checkpoint_from_jax(raw)
    assert payload["step"] == 2 and set(payload) == {"params", "opt_state", "step",
                                                      "ema_params"}
    p_ckpt.save_pytree(tmp_path / "port", payload)

    port = PolicyCNN(dtype=torch.float32)
    port.load_state_dict(p_ckpt.restore_params(tmp_path / "port", port.state_dict()))
    want = np.asarray(model.apply({"params": jstate.ema_params}, jbatch[0]))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    pcfg = {"LEARNING_RATE": 1e-3, "LR_MILESTONES": [], "gradient_clip_val": 0.5}
    pstate = steps.create_train_state(PolicyCNN(dtype=torch.float32),
                                      steps.make_optimizer(pcfg, steps_per_epoch=4),
                                      ema_decay=0.5, device="cpu")
    pstate.load_payload(p_ckpt.restore_pytree(tmp_path / "port"))
    jstate, _ = jstep(jstate, jbatch, jax.random.PRNGKey(0))
    steps.make_train_step(losses.bc_loss_fn)(
        pstate, (torch.from_numpy(x), torch.from_numpy(y)))
    want = convert.policy_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, v in pstate.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert pstate.step == 3

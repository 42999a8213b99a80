"""BC training: the port's losses, optimizer, train state and ``Trainer``
against the JAX package's on the CPU, fp32 unless stated, 64² frames,
batch 8, weights carried across with ``convert``.

Tolerances: CE and accuracy rtol 1e-6; loss rtol 1e-5; gradients rtol 1e-4 /
atol 1e-6 (fp32 matmuls on both sides, ``tests/conftest.py``); parameters
after Adam steps rtol 1e-4 / atol 1e-5, 1 % of one step's learning rate
(Adam divides each gradient by its own running magnitude, so where a
gradient is near zero its rounding error moves the update by a fraction
of the rate: 4.1e-6 on one element of 73,728 after three steps from
flax-initialized weights; 6.8e-7 at most from the draws used here); fit
histories rtol 1e-4; the bf16 step within the spread of
bf16 arithmetic (loss rtol 1e-2, gradients 3e-2 of each tensor's norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_imitation_learning_tpu.data.pipeline import DeviceDataset as JDataset
from carla_imitation_learning_tpu.data.pipeline import FrameStore as JStore
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu.training import losses as j_losses
from carla_imitation_learning_tpu.training import steps as j_steps
from carla_imitation_learning_tpu.training.loop import Trainer as JTrainer
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
from carla_imitation_learning_tpu_torch.models import PolicyCNN
from carla_imitation_learning_tpu_torch.training import losses, steps
from carla_imitation_learning_tpu_torch.training.loop import Trainer

HW, BATCH = 64, 8
CLIP_CFG = {"LEARNING_RATE": 1e-3, "LR_MILESTONES": [], "gradient_clip_val": 0.5}
NO_CLIP_CFG = {"LEARNING_RATE": 1e-3, "LR_MILESTONES": []}


def _jax_params(seed):
    """PolicyCNN params drawn with numpy: kernels normal with std
    sqrt(1 / fan_in), biases normal with std 0.1 (flax's own initializer
    takes seconds to compile; ``test_init_statistics_match_flax`` runs it)."""
    shapes = jax.eval_shape(JPolicyCNN(dtype=jnp.float32).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, HW, HW, 4)))["params"]
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 0.1 if len(s.shape) == 1 else 1 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray((rng.normal(size=s.shape) * scale).astype(np.float32))

    return jax.tree_util.tree_map(draw, shapes)


def _jax_state(cfg, seed=0, dtype=jnp.float32, ema_decay=0.0, steps_per_epoch=1):
    """A JAX ``TrainState`` built as ``create_train_state`` builds it, from
    ``_jax_params(seed)``."""
    model = JPolicyCNN(dtype=dtype)
    tx = j_steps.make_optimizer(cfg, steps_per_epoch=steps_per_epoch)
    params = _jax_params(seed)
    return j_steps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
        apply_fn=model.apply, tx=tx,
        ema_params=jax.tree_util.tree_map(jnp.copy, params) if ema_decay > 0.0 else None,
        ema_decay=float(ema_decay))


def _port_state(jstate, cfg, dtype=torch.float32, steps_per_epoch=1):
    return convert.train_state_from_jax(
        jstate, steps.make_optimizer(cfg, steps_per_epoch=steps_per_epoch),
        dtype=dtype, device="cpu")


def _batches(n_batches=3, seed=0):
    """The same (x, y) batches from each package's dataset."""
    store = JStore.synthetic(n=n_batches * BATCH + 4, height=HW, width=HW, seed=seed)
    pstore = FrameStore(store.frames, store.actions, store.traffic, store.sensors)
    j_ds = JDataset(store, BATCH, shuffle=True, seed=seed)
    p_ds = DeviceDataset(pstore, BATCH, shuffle=True, seed=seed, device="cpu")
    return list(j_ds), list(p_ds)


def _params_close(p_model, jparams, rtol=1e-4, atol=1e-5, what="params"):
    want = convert.policy_state_dict(jparams)
    got = p_model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def _jax_grads(jstate, batch):
    def wrapped(params):
        return j_losses.bc_loss_fn(params, jstate.apply_fn, batch)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(wrapped, has_aux=True))(jstate.params)
    return loss, metrics, grads


def _port_grads(pstate, batch):
    pstate.optimizer.zero_grad(set_to_none=True)
    loss, metrics = losses.bc_loss_fn(pstate.model, batch)
    loss.backward()
    return loss, metrics, {k: p.grad for k, p in pstate.model.named_parameters()}


def _global_norm(grads):
    return float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))


def test_cross_entropy_and_accuracy_match():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 16)
    labels[:4] = logits[:4].argmax(-1)
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(logits).to(dtype)
        j = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                   else jnp.float32)
        np.testing.assert_allclose(
            float(losses.cross_entropy(t, torch.from_numpy(labels))),
            float(j_losses.cross_entropy(j, jnp.asarray(labels))), rtol=1e-6)
        assert float(losses.accuracy(t, torch.from_numpy(labels))) == \
            float(j_losses.accuracy(j, jnp.asarray(labels)))


def test_loss_and_grads_match():
    jstate = _jax_state(CLIP_CFG, seed=1)
    pstate = _port_state(jstate, CLIP_CFG)
    (jb, *_), (pb, *_) = _batches()
    jloss, jmetrics, jgrads = _jax_grads(jstate, jb)
    ploss, pmetrics, pgrads = _port_grads(pstate, pb)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-5)
    assert float(pmetrics["accuracy"]) == float(jmetrics["accuracy"])
    want = convert.policy_state_dict(jgrads)
    for k, g in pgrads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(
        steps.predict_step(pstate.model, pb[0]).numpy(),
        np.asarray(j_steps.predict_step(jstate.apply_fn, jstate.params, jb[0])))


@pytest.mark.parametrize("milestones", [[], [2, 5], [3, 3, 7]])
def test_lr_schedule_matches(milestones):
    cfg = {"LEARNING_RATE": 2e-3, "LR_MILESTONES": milestones, "LR_GAMMA": 0.3}
    spe = 10
    j_sched = j_steps.make_lr_schedule(cfg, steps_per_epoch=spe)
    p_sched = steps.make_lr_schedule(cfg, steps_per_epoch=spe)
    around = sorted({max(0, m * spe + d) for m in [0] + milestones for d in (-1, 0, 1)}
                    | {0, 100})
    for count in around:
        np.testing.assert_allclose(p_sched(count), float(j_sched(count)), rtol=1e-6,
                                   err_msg=f"count {count}")


RUN_CFG = {"LEARNING_RATE": 1e-3, "LR_MILESTONES": [1, 2], "LR_GAMMA": 0.5}
RUN_EMA = 0.5


@pytest.fixture(scope="module")
def jax_runs():
    """``get(clip)``: three JAX train steps (the rate halving after steps 1
    and 2, an EMA shadow) from ``_jax_params(2)`` on ``_batches(seed=2)``,
    the state after each step as numpy trees; run once per clip value."""
    runs = {}

    def get(clip):
        if clip not in runs:
            cfg = {**RUN_CFG, "gradient_clip_val": clip}
            jstate = _jax_state(cfg, seed=2, ema_decay=RUN_EMA)
            j_batches, p_batches = _batches(seed=2)
            j_step = j_steps.make_train_step(j_losses.bc_loss_fn, donate=False)
            states, losses = [jax.tree_util.tree_map(np.asarray, jstate)], []
            for jb in j_batches:
                jstate, jm = j_step(jstate, jb, jax.random.PRNGKey(0))
                states.append(jax.tree_util.tree_map(np.asarray, jstate))
                losses.append(float(jm["loss"]))
            runs[clip] = {"cfg": cfg, "states": states, "losses": losses,
                          "j_batches": j_batches, "p_batches": p_batches}
        return runs[clip]

    return get


@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clip_triggered", "clip_not_triggered"])
def test_optimizer_steps_match(clip, jax_runs):
    run = jax_runs(clip)
    pstate = _port_state(run["states"][0], run["cfg"])
    norm = _global_norm(_port_grads(pstate, run["p_batches"][0])[2])
    assert (norm > clip) == (clip == 0.5), norm
    p_step = steps.make_train_step(losses.bc_loss_fn)
    for pb, jloss in zip(run["p_batches"], run["losses"]):
        pstate, pm = p_step(pstate, pb)
        np.testing.assert_allclose(float(pm["loss"]), jloss, rtol=1e-5)
    assert pstate.step == int(run["states"][3].step) == 3
    _params_close(pstate.model, run["states"][3].params)


def test_train_state_from_jax_continues_the_run(jax_runs):
    """Two JAX steps, then the state crosses over: one more step in each
    package lands on the same parameters, Adam moments, EMA and step count."""
    run = jax_runs(0.5)
    pstate = _port_state(run["states"][2], run["cfg"])
    assert pstate.step == 2 and pstate.tx.schedule(pstate.step) == pytest.approx(2.5e-4)
    _params_close(pstate.ema, run["states"][2].ema_params, rtol=0, atol=0, what="ema")
    steps.make_train_step(losses.bc_loss_fn)(pstate, run["p_batches"][2])
    want = run["states"][3]
    assert pstate.step == int(want.step) == 3
    _params_close(pstate.model, want.params)
    _params_close(pstate.ema, want.ema_params, what="ema")
    adam = convert._adam_state(want.opt_state)
    moments = pstate.optimizer.state_dict()["state"]
    for i, (name, _) in enumerate(pstate.model.named_parameters()):
        assert float(moments[i]["step"]) == int(adam.count) == 3
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            np.testing.assert_allclose(moments[i][key].numpy(),
                                       convert.policy_state_dict(tree)[name].numpy(),
                                       rtol=1e-4, atol=1e-9, err_msg=f"{key} {name}")


def test_ema_shadow_matches(jax_runs):
    """The shadow after three steps from the start, and the eval step
    scoring the shadow, as the JAX package's does."""
    run = jax_runs(0.5)
    pstate = _port_state(run["states"][0], run["cfg"])
    assert pstate.ema is not None and pstate.ema_decay == RUN_EMA
    assert steps.eval_params(pstate) is pstate.ema
    p_step = steps.make_train_step(losses.bc_loss_fn)
    for pb in run["p_batches"]:
        p_step(pstate, pb)
    jstate = jax.tree_util.tree_map(jnp.asarray, run["states"][3])
    _params_close(pstate.ema, jstate.ema_params, what="ema")
    jm = j_steps.make_eval_step(j_losses.bc_loss_fn)(jstate, run["j_batches"][0])
    pm = steps.make_eval_step(losses.bc_loss_fn)(pstate, run["p_batches"][0])
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)


def _fit_loaders(pkg):
    store = JStore.synthetic(n=32, height=HW, width=HW, seed=0)
    if pkg == "jax":
        return {"train_dataloader": JDataset(store, BATCH, shuffle=True, seed=5),
                "val_dataloader": JDataset(store, BATCH)}
    pstore = FrameStore.synthetic(n=32, height=HW, width=HW, seed=0)
    return {"train_dataloader": DeviceDataset(pstore, BATCH, shuffle=True, seed=5,
                                              device="cpu"),
            "val_dataloader": DeviceDataset(pstore, BATCH, device="cpu")}


def _port_fit(tiny_cfg, jstate):
    loaders = _fit_loaders("torch")
    pstate = convert.train_state_from_jax(
        jstate, steps.make_optimizer(tiny_cfg, steps_per_epoch=len(loaders["train_dataloader"])),
        device="cpu")
    return Trainer(tiny_cfg, device="cpu").fit(pstate, losses.bc_loss_fn, loaders,
                                                max_epochs=2)


def test_fit_matches_jax(tiny_cfg):
    """Two epochs of ``Trainer.fit`` (sanity val step, shuffled train loader,
    the fused path) in each package from the same weights."""
    loaders = _fit_loaders("jax")
    jstate = _jax_state(tiny_cfg, seed=11, steps_per_epoch=len(loaders["train_dataloader"]))
    start = jax.tree_util.tree_map(np.asarray, jstate)
    jres = JTrainer(tiny_cfg).fit(jstate, j_losses.bc_loss_fn, loaders,
                                  jax.random.PRNGKey(12), max_epochs=2)
    pres = _port_fit(tiny_cfg, start)
    assert len(pres.history) == len(jres.history) == 2
    for prow, jrow in zip(pres.history, jres.history):
        assert set(prow) == set(jrow)
        for k in jrow:
            np.testing.assert_allclose(prow[k], jrow[k], rtol=1e-4, err_msg=k)
    _params_close(pres.state.model, jres.state.params)
    assert pres.throughput["images_per_sec"] > 0


def test_fit_is_bitwise_deterministic(tiny_cfg):
    start = _jax_state(CLIP_CFG, seed=11)
    r1, r2 = _port_fit(tiny_cfg, start), _port_fit(tiny_cfg, start)
    assert r1.history == r2.history
    for (k, a), b in zip(r1.state.model.state_dict().items(),
                         r2.state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_nan_rollback_restores_snapshot(tiny_cfg):
    """A non-finite epoch loss rolls the model, the optimizer and the step
    count back to the state after the last good epoch."""
    poison = {"on": False}

    def loss_fn(model, batch, generator=None):
        loss, metrics = losses.bc_loss_fn(model, batch, generator)
        if poison["on"]:
            loss = loss * torch.tensor(float("nan"))
            metrics = {**metrics, "loss": loss.detach()}
        return loss, metrics

    saved = {}

    class Poisoner:
        def on_epoch_end(self, trainer, state, epoch, metrics, loaders):
            if epoch == 0:
                saved.update(state.snapshot())
                poison["on"] = True

    loaders = _fit_loaders("torch")
    pstate = _port_state(_jax_state(CLIP_CFG, seed=6), CLIP_CFG)
    trainer = Trainer(tiny_cfg, callbacks=[Poisoner()], device="cpu")
    res = trainer.fit(pstate, loss_fn, loaders, max_epochs=2)
    assert trainer.nan_events == 1
    assert res.history[1]["nan_rollback"] == 1.0 and "nan_rollback" not in res.history[0]
    assert not np.isfinite(res.history[1]["train_loss"])
    assert res.state.step == saved["step"] == len(loaders["train_dataloader"])
    for k, v in saved["model"].items():
        assert torch.equal(res.state.model.state_dict()[k], v), k
    moments = res.state.optimizer.state_dict()["state"]
    for i, m in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(moments[i][key], m[key]), (i, key)


def test_bf16_step_matches():
    jstate = _jax_state(CLIP_CFG, seed=7, dtype=jnp.bfloat16)
    pstate = _port_state(jstate, CLIP_CFG, dtype=torch.bfloat16)
    (jb, *_), (pb, *_) = _batches(seed=7)
    jloss, _, jgrads = _jax_grads(jstate, jb)
    ploss, _, pgrads = _port_grads(pstate, pb)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-2)
    want = convert.policy_state_dict(jgrads)
    for k, g in pgrads.items():
        err = float(torch.linalg.vector_norm(g - want[k]))
        assert err <= 3e-2 * float(torch.linalg.vector_norm(want[k])) + 1e-6, (k, err)


def test_init_statistics_match_flax():
    """``create_train_state`` draws flax's lecun_normal: per layer, std
    sqrt(1 / fan_in) within 4 standard errors, no value beyond 2 std of the
    underlying normal, zero biases; the JAX package's draw passes the same
    test."""
    model = PolicyCNN(dtype=torch.float32)
    steps.create_train_state(model, steps.make_optimizer(NO_CLIP_CFG),
                             generator=torch.Generator().manual_seed(0), device="cpu")
    jparams = convert.policy_state_dict(JPolicyCNN(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 4)))["params"])
    for name, p in model.state_dict().items():
        for w in (p, jparams[name]):
            if name.endswith("bias"):
                assert not w.any(), name
                continue
            fan_in = w[0].numel()
            std = float(w.std())
            assert abs(std / np.sqrt(1 / fan_in) - 1) < 4 / np.sqrt(2 * w.numel()), (name, std)
            assert float(w.abs().max()) <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978
    a = steps.flax_init_(PolicyCNN(), torch.Generator().manual_seed(3))
    b = steps.flax_init_(PolicyCNN(), torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_entry_points_refuse_missing_card(tiny_cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.create_train_state(PolicyCNN(), steps.make_optimizer(NO_CLIP_CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tiny_cfg)
    with pytest.raises(ValueError, match="trace_dir"):   # a trace needs somewhere to go
        Trainer({"trainer": {"profiler": "trace"}}, device="cpu")


def test_unfused_fit_matches_fused(tiny_cfg):
    """``profiler="simple"`` takes the per-batch path (host index upload per
    batch, one eval step per validation batch): the same history, bit for
    bit; the logger, the checkpoint manager and ``test`` are called."""
    calls = {"scalars": 0, "flat": 0, "saved": []}

    class Logger:
        def add_scalars(self, tag, values, step):
            calls["scalars"] += 1
            assert tag == "losses" and set(values) == {"train_loss", "val_loss"}

        def add_scalars_flat(self, values, step):
            calls["flat"] += 1

    class Checkpoints:
        best = {"metric": 1.0, "path": "p"}

        def save(self, epoch, payload, row):
            calls["saved"].append((epoch, sorted(payload), payload["step"]))

    start = _jax_state(CLIP_CFG, seed=11)
    fused = _port_fit(tiny_cfg, start)
    cfg = tiny_cfg.copy()
    cfg.set_dotted("trainer.profiler", "simple")
    loaders = _fit_loaders("torch")
    pstate = convert.train_state_from_jax(
        start, steps.make_optimizer(cfg, steps_per_epoch=len(loaders["train_dataloader"])),
        device="cpu")
    trainer = Trainer(cfg, logger=Logger(), checkpoint_manager=Checkpoints(), device="cpu")
    res = trainer.fit(pstate, losses.bc_loss_fn, loaders, max_epochs=2)
    assert res.history == fused.history
    assert calls["scalars"] == calls["flat"] == 2 and res.best_path == "p"
    nb = len(loaders["train_dataloader"])
    assert calls["saved"] == [(0, ["opt_state", "params", "step"], nb),
                              (1, ["opt_state", "params", "step"], 2 * nb)]
    metrics = trainer.test(res.state, losses.bc_loss_fn,
                           {"test_dataloader": loaders["val_dataloader"]})
    np.testing.assert_allclose(metrics["test_loss"], res.history[-1]["val_loss"], rtol=1e-6)

"""Online DAgger in the port (``training/online_dagger.py``) against the
JAX package's single-program DAgger, on the CPU.

``jax.random`` draws cannot be made from a ``torch.Generator``, so the
draws are injected:
- window sampling: the (round, step) indices JAX's ``sample_windows`` draws
  from its key are recomputed from that key and handed to the port's
  ``gather_windows_at`` (the four cases of ``tests/test_online_dagger.py``);
  in the whole run, the port's ``window_indices`` returns, step by step,
  the indices JAX's run draws from its key chain;
- the first fleet: JAX's run resets from its key; the port's ``reset_env``
  returns the same states, converted;
- the β coin: with ``beta=0`` round 0 is the expert (0**0 = 1) and later
  rounds the policy alone, so no coin is drawn.

The JAX run renders with its fast Pallas kernel in interpret mode and the
exact reciprocal (as ``tests/test_torch_rollout_rich.py`` does), so both
packages see nearly the same uint8 frames; the final parameters are held
on a second run in which both render stand-in frames computed exactly from
the state (see ``test_online_run_matches_jax``). Tolerances: windows,
labels and weights equal; agreement equal; valid_frac, a float32 mean of
per-step means that XLA and torch may round apart by an ulp, rtol 1e-6;
per-round loss rtol 1e-5; parameters after the run's Adam steps rtol 1e-4
/ atol 1e-5 (``tests/test_torch_training.py``).
"""

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import carla_imitation_learning_tpu.ops.raster_fast as j_raster_fast
import carla_imitation_learning_tpu.training.online_dagger as j_od
from carla_imitation_learning_tpu.models import PolicyCNN as JPolicyCNN
from carla_imitation_learning_tpu.render.pipeline import RenderConfig as JRenderConfig
from carla_imitation_learning_tpu.sim import SimParams as JParams
from carla_imitation_learning_tpu.sim import make_town
from carla_imitation_learning_tpu.sim.world import make_spawn_pool, pack_spawn_pool, reset_env
from carla_imitation_learning_tpu.training import steps as j_steps
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch.models import PolicyCNN
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
from carla_imitation_learning_tpu_torch.sim.world import SimParams
from carla_imitation_learning_tpu_torch.training import online_dagger as p_od
from carla_imitation_learning_tpu_torch.training import steps

ROOT = Path(__file__).resolve().parents[1]
HW = 32
N_ENVS, N_STEPS, ROUNDS, TRAIN_STEPS, BATCH = 3, 12, 3, 3, 12
TOWN = make_town(blocks=2, n_buildings=6, n_lights=2)
P_TOWN = convert.town_from_jax(TOWN)
# episodes of 20 steps: every env resets in round 1, so windows get torn
J_PARAMS, P_PARAMS = JParams(n_agents=3, episode_len=20), SimParams(n_agents=3, episode_len=20)
J_RCFG = JRenderConfig(HW, HW, max_triangles=256, backend="pallas")
P_RCFG = RenderConfig(HW, HW, max_triangles=256)
CFG = {"LEARNING_RATE": 1e-3, "LR_MILESTONES": [], "gradient_clip_val": 0.5}


def _buffer(R=2, T=10, B=3, H=4, W=4, dones=None):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (R, T, B, H, W)).astype(np.uint8)
    labels = rng.integers(0, 9, (R, T, B)).astype(np.int32)
    if dones is None:
        dones = np.zeros((R, T, B), bool)
    return frames, labels, dones


def _jax_indices(key, r, R, T, B, k):
    """The (r_i, t_i) that JAX's ``sample_windows`` draws from ``key``."""
    kr, kt = jax.random.split(key)
    r_i = jax.random.randint(kr, (B, k), 0, jnp.minimum(jnp.int32(r) + 1, R))
    t_i = jax.random.randint(kt, (B, k), 0, T)
    return torch.from_numpy(np.array(r_i)).long(), torch.from_numpy(np.array(t_i)).long()


def _both(seed, frames, labels, dones, r, k, fs=4):
    """JAX's ``sample_windows`` and the port's ``gather_windows_at`` at the
    indices JAX drew: equal windows, labels and weights. → the port's
    outputs and the indices."""
    key = jax.random.PRNGKey(seed)
    j_obs, j_y, j_w = j_od.sample_windows(key, jnp.asarray(frames), jnp.asarray(labels),
                                          jnp.asarray(dones), r=jnp.int32(r), k_per_env=k,
                                          frame_skip=fs)
    r_i, t_i = _jax_indices(key, r, *labels.shape, k)
    obs, y, w = p_od.gather_windows_at(torch.from_numpy(frames), torch.from_numpy(labels),
                                       torch.from_numpy(dones), r_i, t_i, fs)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(j_obs))
    np.testing.assert_array_equal(y.numpy(), np.asarray(j_y))
    np.testing.assert_array_equal(w.numpy(), np.asarray(j_w))
    assert obs.dtype == torch.float32 and w.dtype == torch.float32
    return (obs, y, w), (r_i, t_i)


def test_sample_windows_clean_buffer():
    (obs, y, w), _ = _both(0, *_buffer(), r=1, k=21)
    assert obs.shape == (63, 4, 4, 4) and y.shape == (63,) and w.shape == (63,)
    assert float(obs.min()) >= 0.0 and float(obs.max()) <= 1.0
    assert 0.0 < float(w.mean()) < 1.0


def test_sample_windows_all_done_all_masked():
    frames, labels, _ = _buffer()
    (obs, _, w), _ = _both(1, frames, labels, np.ones((2, 10, 3), bool), r=1, k=40)
    assert float(w.sum()) == 0.0 and bool(torch.isfinite(obs).all())


def test_sample_windows_respects_round_bound():
    frames, labels, dones = _buffer()
    labels[1] = 8
    labels[0] = np.clip(labels[0], 0, 7)
    (_, y, _), (r_i, _) = _both(2, frames, labels, dones, r=0, k=80)
    assert int(y.max()) <= 7 and int(r_i.max()) == 0


def test_single_window_boundary_semantics():
    """A done after frame 4 tears the windows holding frame 4 as a
    non-final frame (ends 5-7) but not the one ending at 4; ends 0-2 start
    before the trajectory. So exactly the ends {3, 4} carry weight."""
    frames = np.zeros((1, 8, 1, 2, 2), np.uint8)
    labels = np.zeros((1, 8, 1), np.int32)
    dones = np.zeros((1, 8, 1), bool)
    dones[0, 4, 0] = True
    (_, _, w), (_, t_i) = _both(3, frames, labels, dones, r=0, k=512)
    assert torch.equal(w, ((t_i == 3) | (t_i == 4)).reshape(-1).float())
    assert 0.0 < float(w.mean()) < 5.0 / 8.0


def _jax_weights(seed):
    """PolicyCNN params drawn with numpy (kernels with std sqrt(1 / fan_in),
    biases with std 0.1), as ``tests/test_torch_training.py`` draws them."""
    shapes = jax.eval_shape(JPolicyCNN(dtype=jnp.float32).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, HW, HW, 4)))["params"]
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 0.1 if len(s.shape) == 1 else 1 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray((rng.normal(size=s.shape) * scale).astype(np.float32))

    return jax.tree_util.tree_map(draw, shapes)


def _centred(params, obs):
    """``params`` with the last bias shifted by minus the mean logits on
    ``obs``, so that the policy's argmax follows its input (a random
    network's is nearly constant) and its actions meet the expert's on
    some steps and not on others."""
    m = PolicyCNN(dtype=torch.float32)
    m.load_state_dict(convert.policy_state_dict(params))
    with torch.no_grad():
        mean = m(obs).mean(0).numpy()
    head = dict(params["MLPHead_0"])
    head["Dense_2"] = {**head["Dense_2"], "bias": head["Dense_2"]["bias"] - mean}
    return {**params, "MLPHead_0": head}


def _jax_key_chain(rng):
    """The window indices JAX's ``run(state, rng)`` draws, in order, and its
    first fleet's reset key."""
    k_init, key = jax.random.split(rng)
    indices = []
    for r in range(ROUNDS):
        key, _, k_train = jax.random.split(key, 3)
        for k in jax.random.split(k_train, TRAIN_STEPS):
            indices.append(_jax_indices(k, r, ROUNDS, N_STEPS, N_ENVS, BATCH // N_ENVS))
    return indices, k_init


def _jax_pattern_renderer(params, town, rcfg):
    """A stand-in renderer computed in exact integer arithmetic from the
    state's step counter and route, the same in both packages."""
    def render(state):
        g = (jnp.arange(HW)[:, None] * 3 + jnp.arange(HW)[None, :] * 5
             + state.t * 7 + state.ego_route * 11) % 256
        return {"gray": g.astype(jnp.float32) / 255.0}

    return render


def _port_pattern_renderer(params, town, rcfg, device):
    ar = torch.arange(HW)

    def render(states):
        g = (ar[None, :, None] * 3 + ar[None, None, :] * 5
             + (states.t * 7 + states.ego_route * 11)[:, None, None]) % 256
        return {"gray": g.to(torch.float32) / 255.0}

    return render


def _run_both(pattern_frames: bool):
    """JAX's single-program run and the port's, from the same weights,
    first fleet, spawn pool and windows, at beta=0; with
    ``pattern_frames`` both render the stand-in frames."""
    rng = jax.random.PRNGKey(11)
    indices, k_init = _jax_key_chain(rng)
    states = jax.jit(jax.vmap(lambda k: reset_env(J_PARAMS, TOWN, k)))(
        jax.random.split(k_init, N_ENVS))
    pool = pack_spawn_pool(jax.jit(lambda: make_spawn_pool(
        J_PARAMS, TOWN, jax.random.PRNGKey(0x5EED), 1024))())
    model = JPolicyCNN(dtype=jnp.float32)
    tx = j_steps.make_optimizer(CFG)
    p_states = convert.world_state_from_jax(states)
    render = (_port_pattern_renderer if pattern_frames else p_od.make_renderer)(
        P_PARAMS, P_TOWN, dataclasses.replace(P_RCFG, rgb=False, fast=True), device="cpu")
    first = torch.clamp(render(p_states)["gray"] * 255.0 + 0.5, 0, 255).to(torch.uint8)
    params = _centred(_jax_weights(5), first[..., None].repeat(1, 1, 1, 4).float() / 255.0)
    jstate = j_steps.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=tx.init(params), apply_fn=model.apply, tx=tx,
                                ema_params=None, ema_decay=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_raster_fast, "rasterize_luma_fast",
                   functools.partial(j_raster_fast.rasterize_luma_fast, interpret=True))
        mp.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
        mp.setattr(j_od, "rollout_spawn_pool", lambda params, town: pool)
        if pattern_frames:
            mp.setattr(j_od, "make_renderer", _jax_pattern_renderer)
        jax.clear_caches()
        run = j_od.make_online_dagger(model.apply, J_PARAMS, TOWN, J_RCFG, n_envs=N_ENVS,
                                      n_steps=N_STEPS, rounds=ROUNDS, train_steps=TRAIN_STEPS,
                                      batch=BATCH, beta=0.0)
        j_final, j_metrics = run(jstate, rng)
        j_metrics = {k: np.asarray(v) for k, v in j_metrics.items()}
    jax.clear_caches()

    pstate = convert.train_state_from_jax(jstate, steps.make_optimizer(CFG), device="cpu")
    queue = list(indices)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_od, "reset_env", lambda params, town, gen, n: p_states)
        mp.setattr(p_od, "window_indices", lambda *a: queue.pop(0))
        mp.setattr(p_od, "rollout_spawn_pool",
                   lambda params, town: convert.spawn_pool_from_jax(pool))
        if pattern_frames:
            mp.setattr(p_od, "make_renderer", _port_pattern_renderer)
        run = p_od.make_online_dagger(PolicyCNN.__call__, P_PARAMS, P_TOWN, P_RCFG,
                                      n_envs=N_ENVS, n_steps=N_STEPS, rounds=ROUNDS,
                                      train_steps=TRAIN_STEPS, batch=BATCH, beta=0.0,
                                      device="cpu")
        p_final, p_metrics = run(pstate, torch.Generator().manual_seed(0))
    assert not queue
    return (j_final, j_metrics), (p_final, p_metrics)


def _metrics_match(jm, pm):
    assert jm["agreement"][0] == 1.0 and 0.0 < jm["agreement"][1:].max() < 1.0
    assert np.all((jm["valid_frac"] > 0) & (jm["valid_frac"] < 1))
    np.testing.assert_array_equal(pm["agreement"], jm["agreement"])
    # the weights agree exactly; their float32 means of means may round apart
    np.testing.assert_allclose(pm["valid_frac"], jm["valid_frac"], rtol=1e-6)
    assert pm["agreement"].shape == pm["valid_frac"].shape == (ROUNDS,)
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5, err_msg="loss")


def test_online_run_matches_jax():
    """The run with each package's own renderer (kernel B's plain version,
    JAX's fast kernel in interpret mode): per-round loss, agreement and
    valid_frac. Their frames agree within the fast-raster tolerance, not bit
    for bit, and a pixel whose quantization flips moves the first
    convolution's weight gradient where it is routed through a ReLU and
    pool; the parameters are held in the next test."""
    (j_final, jm), (p_final, pm) = _run_both(pattern_frames=False)
    _metrics_match(jm, pm)
    assert p_final.step == int(j_final.step) == ROUNDS * TRAIN_STEPS


def test_online_run_parameters_match_jax():
    """The same run on stand-in frames that both packages compute exactly:
    the metrics, and every parameter after the run's nine Adam steps."""
    (j_final, jm), (p_final, pm) = _run_both(pattern_frames=True)
    _metrics_match(jm, pm)
    assert p_final.step == int(j_final.step) == ROUNDS * TRAIN_STEPS
    want = convert.policy_state_dict(j_final.params)
    for k, v in p_final.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_beta_one_stays_expert():
    state = steps.create_train_state(PolicyCNN(dtype=torch.float32),
                                     steps.make_optimizer(CFG),
                                     generator=torch.Generator().manual_seed(0), device="cpu")
    run = p_od.make_online_dagger(PolicyCNN.__call__, P_PARAMS, P_TOWN, P_RCFG, n_envs=2,
                                  n_steps=8, rounds=2, train_steps=2, batch=8, beta=1.0,
                                  device="cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    state, m = run(state, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(m["agreement"], 1.0)
    assert np.all(np.isfinite(m["loss"])) and state.step == 4
    assert any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters()))


def test_online_dagger_refuses():
    with pytest.raises(NotImplementedError):
        p_od.make_online_dagger(PolicyCNN.__call__, P_PARAMS, P_TOWN, P_RCFG, 2, 4, 1, 1,
                                4, device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_od.make_online_dagger(PolicyCNN.__call__, P_PARAMS, P_TOWN, P_RCFG, 2, 4, 1, 1, 4)


def test_run_dagger_online_tiny():
    """The ``dagger_online`` loop at a toy size: per-round metrics, the
    final evaluation, and ``beta`` passed through (β = 1 keeps every
    round the expert's)."""
    from carla_imitation_learning_tpu_torch.training import dagger

    kw = dict(rounds=2, n_envs=2, n_steps=8, train_steps_per_round=2, eval_steps=6,
              batch_size=4, device="cpu")
    out = dagger.run_dagger_online(P_PARAMS, P_TOWN, P_RCFG, torch.Generator().manual_seed(0),
                                   **kw)
    assert out["agreement_per_round"][0] == 1.0
    for key in ("loss_per_round", "agreement_per_round", "valid_frac_per_round"):
        assert len(out[key]) == 2 and np.all(np.isfinite(out[key])), key
    final = out["final_eval"]
    assert final["env_steps"] == 2 * 6 and np.isfinite(final["driving_score"])
    expert = dagger.run_dagger_online(P_PARAMS, P_TOWN, P_RCFG,
                                      torch.Generator().manual_seed(0), beta=1.0, **kw)
    assert expert["agreement_per_round"] == [1.0, 1.0]
    # goals plan over the turn-fan graph, which this town lacks
    with pytest.raises(ValueError, match="turn_fans"):
        dagger.run_dagger_online(P_PARAMS, P_TOWN, P_RCFG, torch.Generator(), n_goals=2,
                                 device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dagger.run_dagger_online(P_PARAMS, P_TOWN, P_RCFG, torch.Generator())


def test_dagger_online_bench_tiny(tmp_path):
    """The online-versus-host A/B at a toy size on the CPU."""
    spec = importlib.util.spec_from_file_location(
        "dagger_online_bench_torch", ROOT / "benchmarks_torch" / "dagger_online_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    out = tmp_path / "ab.json"
    bench.main(["--device", "cpu", "--rounds", "2", "--envs", "2", "--steps", "8",
                "--train-steps", "3", "--batch", "4", "--out", str(out)])
    report = json.loads(out.read_text())
    for key in ("online_cold_s", "online_warm_s", "host_cold_s", "host_warm_s", "speedup_warm"):
        assert report[key] > 0, key
    assert report["online_agreement"][0] == 1.0 and len(report["online_loss_per_round"]) == 2
    assert np.all(np.isfinite(report["host_final_loss_per_round"]))
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--out", str(ROOT / "reports" / "x.json")])


def test_online_dagger_ablation_tiny(tmp_path):
    """The ablation of online DAgger's agreement at a toy size on the CPU:
    every setting runs, and the action histograms count every step."""
    spec = importlib.util.spec_from_file_location(
        "online_dagger_ablation_torch", ROOT / "benchmarks_torch" / "online_dagger_ablation.py")
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    out = tmp_path / "ablation.json"
    ablation.main(["--device", "cpu", "--rounds", "3", "--envs", "2", "--steps", "6",
                   "--train-steps", "2", "--batch", "4", "--bc-envs", "2", "--bc-steps", "12",
                   "--bc-epochs", "1", "--bc-batches", "2", "--hw", "32", "--seeds", "1",
                   "--out", str(out)])
    report = json.loads(out.read_text())
    runs = report["runs"]
    assert {(r["init"], r["lod_px"], r["train"]) for r in runs} == {
        (i, lod, t) for i in ("bc", "fresh") for lod in (0.0, 2.0) for t in ("frozen", 2)}
    for r in runs:
        assert r["agreement"][0] == 1.0 and len(r["loss"]) == 3
        assert [sum(h) for h in r["expert_actions"]] == [2 * 6] * 3
        assert [sum(h) for h in r["policy_actions"]] == [0, 2 * 6, 2 * 6]
    with pytest.raises(SystemExit):
        ablation.main(["--device", "cpu", "--out", str(ROOT / "reports" / "x.json")])


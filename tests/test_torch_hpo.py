"""The port's hyperparameter search (``parallel/hpo.py``, the functional
Adam of ``training/steps.py``, ``experiments._bc_vmap_trainable``) against
the JAX package's, on the CPU.

- ``grid_space`` and ``sample_space`` give the JAX package's trial configs
  for the same space and seed (equal).
- ``tune_run``: the best trial by mode, failed trials recorded with their
  traceback, an all-failed sweep raising, ``trials.json`` with JAX's fields
  and values, and a concurrent sweep equal to the serial one.
- ``vmap_sweep`` on JAX's quadratic bowl (``tests/test_parallel.py``) from
  the same starting ``w``: final ``w`` within rtol 1e-6, the losses
  within rtol 1e-5 (near the bottom, ``w``'s last-bit rounding of about
  1e-7 · 3 weighs 1 / |w − 3| ≈ 50 times more in ``(w − 3)²``).
- ``adam_update`` vmapped over per-trial rates against optax's
  ``inject_hyperparams(adam)`` vmapped alike: parameters rtol 1e-4 / atol
  1e-5, the port's tolerance for Adam steps.
- ``_bc_vmap_trainable``'s ``train_fn`` at 32² from the JAX package's
  stacked initial parameters (carried over by ``convert``), on the batches
  both packages build from one synthetic log, at ``hpo_vmap``'s first two
  rates (3e-4, 1e-3): trained parameters within rtol 1e-4 and atol 2e-2 ·
  lr, 2 % of one Adam step, validation loss rtol 1e-4, accuracy equal;
  each vmapped trial equals the same trial trained alone within the same
  bounds (the vmapped convolutions sum in another order). Adam's first
  step moves every element by about lr whatever its gradient's size, so a
  gradient within rounding of zero can take either sign: at 1e-2 and above
  this net's training diverges and such elements end up to 0.15 lr apart
  (against 0.003 lr at 1e-3), which no fixed tolerance on a step tells
  from a fault.
- ``pbt_run``: every generation's scores and rates, the final rates and
  the gathered states bit for bit against JAX's ``pbt_run`` for the same
  key and scores, with tied scores, in both modes; ``hpo_pbt``'s initial
  draws bit for bit (its rates, after ``exp``, within one float32 ulp).
- ``ops/cuda_lib.py``: four threads that reach a library's first use
  together compile it once and share one handle; the wrappers' launch
  counter loses no count under 16 threads.
"""

import ctypes
import json
import os
import stat
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import vmap

import carla_imitation_learning_tpu.experiments as j_ex
import carla_imitation_learning_tpu.parallel.hpo as j_hpo
from carla_imitation_learning_tpu import compose as j_compose
from carla_imitation_learning_tpu_torch import convert
from carla_imitation_learning_tpu_torch import experiments as p_ex
from carla_imitation_learning_tpu_torch.config import compose as p_compose
from carla_imitation_learning_tpu_torch.ops import cuda_lib
from carla_imitation_learning_tpu_torch.parallel import hpo as p_hpo
from carla_imitation_learning_tpu_torch.sim import prng
from carla_imitation_learning_tpu_torch.training.steps import adam_init, adam_update

SPACES = [
    {"lr": (1e-4, 1e-2), "epochs": [2], "seed": [0, 1, 2, 3]},
    {"x": (-1.0, 3.0), "opt": ["adam", "sgd", "rmsprop"], "w": (0.5, 8)},
]


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_space_matches(space, seed):
    assert p_hpo.sample_space(space, 6, seed) == j_hpo.sample_space(space, 6, seed)


def test_grid_space_matches():
    space = {"z": [64, 128, 512], "rnn": ["lstm", "gru"], "loss": ["mse", "ms_ssim"]}
    assert p_hpo.grid_space(space) == j_hpo.grid_space(space)
    assert len(p_hpo.grid_space(space)) == 12


def _bowl(config):
    if config["x"] == 1:
        raise RuntimeError("boom")
    return {"mean_accuracy": 1.0 - (config["x"] - 2) ** 2}


@pytest.mark.parametrize("mode,want", [("max", 2), ("min", 0)])
def test_tune_run_best_failed_and_trials_file(tmp_path, mode, want):
    grid = [{"x": i} for i in range(4)]
    results = {}
    for name, mod in (("jax", j_hpo), ("port", p_hpo)):
        best, trials = mod.tune_run(_bowl, trial_configs=grid, mode=mode,
                                    results_dir=str(tmp_path / name))
        assert best.config["x"] == want and not best.failed
        assert [t.failed for t in trials] == [False, True, False, False]
        assert "boom" in trials[1].error
        results[name] = json.loads((tmp_path / name / "trials.json").read_text())
    for a, b in zip(results["jax"], results["port"]):
        assert set(a) == set(b) == {"trial_id", "config", "metrics", "checkpoint_path", "error"}
        assert (a["trial_id"], a["config"], a["metrics"], a["checkpoint_path"]) == \
            (b["trial_id"], b["config"], b["metrics"], b["checkpoint_path"])
        assert (a["error"] is None) == (b["error"] is None)


def test_tune_run_all_failed_raises():
    def bad(config):
        raise ValueError("nope")

    with pytest.raises(RuntimeError, match="every trial failed"):
        p_hpo.tune_run(bad, trial_configs=[{"x": 0}, {"x": 1}], max_concurrent=2)
    with pytest.raises(ValueError, match="need space or trial_configs"):
        p_hpo.tune_run(bad)


def test_tune_run_concurrent_equals_serial():
    """Trials overlap on the pool (a barrier of 4 passes only if they do),
    keep their order and give the serial sweep's metrics."""
    barrier = threading.Barrier(4, timeout=10)

    def trainable(config):
        if config.get("wait"):
            barrier.wait()
        return {"mean_accuracy": config["lr"] * 10}

    space = {"lr": (1e-4, 1e-2), "epochs": [2], "seed": [0, 1, 2, 3]}
    serial = p_hpo.tune_run(trainable, space=space, num_samples=4)
    grid = [{**c, "wait": True} for c in p_hpo.sample_space(space, 4)]
    best, trials = p_hpo.tune_run(trainable, trial_configs=grid, max_concurrent=4)
    assert [t.trial_id for t in trials] == [0, 1, 2, 3]
    assert [t.metrics for t in trials] == [t.metrics for t in serial[1]]
    assert best.trial_id == serial[0].trial_id


def test_vmap_sweep_quadratic_bowl():
    """JAX's bowl: both sweeps from the same starting ``w``."""

    def j_init(r, h):
        return {"w": jax.random.normal(r, (4,))}

    def j_train(state, lr):
        def loss(w):
            return jnp.sum((w - 3.0) ** 2)

        w = state["w"]
        for _ in range(50):
            w = w - lr * jax.grad(loss)(w)
        return {"w": w}, {"final_loss": loss(w)}

    lrs = np.array([0.001, 0.05, 0.1], np.float32)
    j_states, j_metrics = j_hpo.vmap_sweep(j_init, j_train, jnp.asarray(lrs),
                                           jax.random.PRNGKey(0))
    w0 = np.asarray(jax.vmap(j_init)(jax.random.split(jax.random.PRNGKey(0), 3),
                                     jnp.asarray(lrs))["w"])
    start = {float(lr): torch.tensor(w0[i]) for i, lr in enumerate(lrs)}

    def p_init(generator, lr):
        assert isinstance(generator, torch.Generator)
        return {"w": start[float(lr)].clone()}

    def p_train(state, lr):
        def loss(w):
            return ((w - 3.0) ** 2).sum()

        w = state["w"]
        for _ in range(50):
            w = w - lr * torch.func.grad(loss)(w)
        return {"w": w}, {"final_loss": loss(w)}

    p_states, p_metrics = p_hpo.vmap_sweep(p_init, p_train, torch.from_numpy(lrs), prng.key(0))
    np.testing.assert_allclose(p_states["w"].numpy(), np.asarray(j_states["w"]), rtol=1e-6)
    np.testing.assert_allclose(p_metrics["final_loss"].numpy(),
                               np.asarray(j_metrics["final_loss"]), rtol=1e-5)
    assert p_metrics["final_loss"][2] < p_metrics["final_loss"][0]


def test_trial_generators_follow_the_key():
    gens = p_hpo.trial_generators(prng.key(3), 3)
    keys = np.asarray(jax.random.key_data(jax.random.split(jax.random.PRNGKey(3), 3)))
    for g, (hi, lo) in zip(gens, keys.astype(np.int64)):
        assert g.initial_seed() == (int(hi) << 32) | int(lo)


def test_adam_update_matches_optax():
    rng = np.random.default_rng(0)
    lrs = np.array([1e-3, 3e-2, 1e-1], np.float32)
    shapes = {"w": (5, 3), "b": (3,)}
    params = {k: rng.normal(size=(3, *s)).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=(3, *s)) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]

    make_tx = optax.inject_hyperparams(optax.adam)

    def j_run(p, lr, gs):
        tx = make_tx(learning_rate=lr)
        opt = tx.init(p)
        for g in gs:
            updates, opt = tx.update(g, opt, p)
            p = optax.apply_updates(p, updates)
        return p

    want = jax.vmap(j_run, in_axes=(0, 0, 0))(
        params, jnp.asarray(lrs), [{k: jnp.asarray(v) for k, v in g.items()} for g in grads])

    def p_run(p, lr, gs):
        opt = adam_init(p)
        for g in gs:
            p, opt = adam_update(p, g, opt, lr)
        return p, opt["count"]

    got, count = vmap(p_run)({k: torch.from_numpy(v) for k, v in params.items()},
                             torch.from_numpy(lrs),
                             [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads])
    assert count.tolist() == [6, 6, 6]
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def vmap_trainables(tmp_path_factory):
    """Both packages' ``_bc_vmap_trainable`` at 32² on one synthetic log
    (the JAX package writes it, the port reads it), with JAX's stacked
    initial parameters for two rates."""
    tmp = tmp_path_factory.mktemp("hpo_vmap")
    ov = ["model=imitation", "BATCH_SIZE=16", "synthetic_frames=100", "image_height=32",
          "image_width=32", "compute_dtype=float32", f"data_dir={tmp}/data",
          f"log_dir={tmp}/logs"]
    j_init, j_train = j_ex._bc_vmap_trainable(j_compose("config", overrides=ov), 2)
    p_init, p_train = p_ex._bc_vmap_trainable(
        p_compose("config", overrides=ov + ["device=cpu"]), 2)
    lrs = np.array([3e-4, 1e-3], np.float32)
    j_states = jax.jit(jax.vmap(j_init))(jax.random.split(jax.random.PRNGKey(0), 2),
                                         jnp.asarray(lrs))
    j_out, j_metrics = jax.jit(jax.vmap(j_train))(j_states, jnp.asarray(lrs))
    return {"lrs": lrs, "j_states": j_states, "j_out": j_out, "j_metrics": j_metrics,
            "p_init": p_init, "p_train": p_train}


def _trial_params(stacked, i):
    return convert.policy_state_dict(jax.tree_util.tree_map(lambda x: np.asarray(x)[i],
                                                            stacked))


def test_bc_vmap_train_fn_matches_jax(vmap_trainables):
    t = vmap_trainables
    states = [{"params": (sd := _trial_params(t["j_states"]["params"], i)),
               "opt": adam_init(sd)} for i in range(len(t["lrs"]))]
    stacked = p_hpo.tree_map(lambda *xs: torch.stack(xs), *states)
    lrs = torch.from_numpy(t["lrs"])
    out, metrics = vmap(t["p_train"])(stacked, lrs)
    np.testing.assert_array_equal(metrics["mean_accuracy"].numpy(),
                                  np.asarray(t["j_metrics"]["mean_accuracy"]))
    np.testing.assert_allclose(metrics["val_loss"].numpy(),
                               np.asarray(t["j_metrics"]["val_loss"]), rtol=1e-4)
    for i in range(len(lrs)):
        want = _trial_params(t["j_out"]["params"], i)
        for k, v in want.items():
            np.testing.assert_allclose(out["params"][k][i].numpy(), v.numpy(), rtol=1e-4,
                                       atol=2e-2 * float(lrs[i]), err_msg=f"trial {i} {k}")
        # the same trial trained alone
        alone, alone_m = t["p_train"](states[i], lrs[i])
        for k, v in alone["params"].items():
            np.testing.assert_allclose(out["params"][k][i].numpy(), v.numpy(), rtol=1e-4,
                                       atol=2e-2 * float(lrs[i]), err_msg=f"alone {i} {k}")
        assert float(alone_m["mean_accuracy"]) == float(metrics["mean_accuracy"][i])
    np.testing.assert_array_equal(out["opt"]["count"].numpy(),
                                  np.asarray(t["j_out"]["opt"].inner_state[0].count))


def test_bc_vmap_init_is_per_trial(vmap_trainables):
    """``init_fn`` draws each trial from its own generator: two generators
    of one seed give equal weights, two seeds differ; the moments start at 0."""
    init = vmap_trainables["p_init"]
    a, b, c = (init(torch.Generator().manual_seed(s), torch.tensor(1e-3)) for s in (5, 5, 6))
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
    assert not torch.equal(a["params"]["trunk.convs.0.weight"],
                           c["params"]["trunk.convs.0.weight"])
    assert int(a["opt"]["count"]) == 0 and not any(v.any() for v in a["opt"]["mu"].values())


def _pbt_toys(jax_side: bool):
    """init and train functions on the lineage: a member's score is
    ``(orig · 3 + generation) mod 4``, exact in float32, with ties."""
    if jax_side:
        def init(key, h):
            return {"orig": h, "g": jnp.zeros(())}

        def train(state, h):
            g = state["g"]
            return {"orig": state["orig"], "g": g + 1}, {
                "score": jnp.mod(state["orig"] * 3.0 + g, 4.0)}
    else:
        def init(generator, h):
            return {"orig": h.clone(), "g": torch.zeros(())}

        def train(state, h):
            g = state["g"]
            return {"orig": state["orig"], "g": g + 1}, {
                "score": torch.remainder(state["orig"] * 3.0 + g, 4.0)}
    return init, train


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("seed", [0, 3])
def test_pbt_run_matches_jax_bit_for_bit(mode, seed):
    h0 = np.array([0.5, 1.5, 1.5, 2.5, 0.5, 3.5, 1.5, 2.5], np.float32)
    j_states, j_h, j_hist = j_hpo.pbt_run(*_pbt_toys(True), jnp.asarray(h0),
                                          jax.random.PRNGKey(seed), mode=mode,
                                          n_generations=4)
    p_states, p_h, p_hist = p_hpo.pbt_run(*_pbt_toys(False), torch.from_numpy(h0),
                                          prng.key(seed), mode=mode, n_generations=4)
    assert len(p_hist) == len(j_hist) == 4
    for a, b in zip(p_hist, j_hist):
        assert a["generation"] == b["generation"]
        np.testing.assert_array_equal(a["score"], b["score"])
        np.testing.assert_array_equal(a["hparams"], b["hparams"])
    np.testing.assert_array_equal(p_h.numpy(), np.asarray(j_h))
    np.testing.assert_array_equal(p_states["orig"].numpy(), np.asarray(j_states["orig"]))
    assert any(len(set(g["score"].tolist())) < len(h0) for g in p_hist)   # ties occurred
    assert not np.array_equal(p_hist[-1]["hparams"], h0)                     # members replaced


def test_exploit_explore_pattern():
    """The two worst copy the two best (the k-th worst the k-th of the two
    best in ascending order, ties by member order) and only they are
    perturbed, by 0.8 or 1.25."""
    scores = torch.tensor([0.5, 0.25, 0.25, 1.0, 0.5, 0.75, 0.25, 1.0])
    h = torch.arange(1.0, 9.0)
    states = {"x": torch.arange(8) * 10}
    new_states, new_h, src = p_hpo.exploit_explore(states, h, scores, prng.key(1), 2)
    assert src.tolist() == [0, 3, 7, 3, 4, 5, 6, 7]   # order 1 2 6 0 4 5 3 7: 1 ← 3, 2 ← 7
    assert new_states["x"].tolist() == [10 * s for s in src.tolist()]
    ratio = (new_h / h[src]).tolist()
    assert all(r == 1.0 for i, r in enumerate(ratio) if i not in (1, 2))
    assert {round(ratio[1], 6), round(ratio[2], 6)} <= {0.8, 1.25}


@pytest.mark.parametrize("seed,population", [(0, 8), (5, 16)])
def test_hpo_pbt_initial_draws_match(seed, population):
    lo, hi = 1e-4, 3e-2
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    draws = jax.random.uniform(key, (population,), minval=float(np.log(lo)),
                               maxval=float(np.log(hi)))
    got = prng.uniform_range(prng.fold_in(prng.key(seed), 1), (population,),
                             float(np.log(lo)), float(np.log(hi)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(draws))
    np.testing.assert_allclose(p_ex.pbt_initial_lrs(seed, population, lo, hi).numpy(),
                               np.asarray(jnp.exp(draws)), rtol=1.2e-7, atol=0)


def test_cuda_lib_builds_once_under_concurrent_first_use(tmp_path, monkeypatch):
    """Four threads load one library on a cold build directory: one
    compile, one handle (the compiler is a stub that sleeps, then builds an
    empty C library with g++)."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "toy.cu").write_text("// toy\n")
    calls = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        "sleep 0.3\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        f"echo 'int toy_value(void) {{ return 7; }}' | g++ -shared -fPIC -x c - -o \"$2\"\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", build)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(cuda_lib, "_loaded", {})
    start = threading.Barrier(4, timeout=10)
    handles, errors = [], []

    def first_use():
        try:
            start.wait()
            handles.append(cuda_lib.load("toy"))
        except Exception as e:  # noqa: BLE001 — reported by the asserts below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(calls.read_text().splitlines()) == 1
    assert len(handles) == 4 and all(h is handles[0] for h in handles)
    fn = handles[0].toy_value
    fn.restype = ctypes.c_int
    assert fn() == 7
    assert sorted(p.name for p in build.iterdir() if p.suffix == ".so") == [
        cuda_lib.library_path("toy").name]
    assert os.path.exists(cuda_lib.library_path("toy"))


def test_launch_count_loses_no_update_across_threads():
    """16 threads, more than this machine's cores, each count 2,000
    launches on one counter with the interpreter switching threads every
    microsecond: the count is exact."""
    import sys

    from carla_imitation_learning_tpu_torch.ops.raster import LaunchCount

    counter, start = LaunchCount(), threading.Barrier(16, timeout=10)

    def work():
        start.wait()
        for _ in range(2000):
            counter.add()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert counter.launches == 16 * 2000

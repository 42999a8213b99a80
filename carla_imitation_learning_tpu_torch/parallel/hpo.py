"""Hyperparameter search (the JAX package's ``parallel/hpo.py``): a
tune-like trial runner, vectorized sweeps and Population Based Training.

- ``grid_space`` / ``sample_space``: trial configs, from numpy, the same as
  the JAX package's for the same seed;
- ``tune_run``: runs ``trainable(config) -> metrics`` per trial, one at a
  time or ``max_concurrent`` at a time on a thread pool; a raising trial is
  recorded with its traceback and the sweep goes on; ``trials.json`` holds
  every trial;
- ``vmap_sweep``: the whole training of every trial as one
  ``torch.func.vmap`` over states stacked on a leading trial axis, so each
  operation launches once for all trials (as ``training/dagger.py``'s
  ``Ensemble`` stacks its members);
- ``pbt_run``: the population trains vmapped one generation at a time;
  between generations ``exploit_explore`` replaces the worst members by
  perturbed copies of the best on the device, drawing from the port's
  threefry (``sim/prng.py``) so that its choices equal the JAX package's
  for the same key and scores.

A state is a pytree of tensors: nested dicts, lists and tuples.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
from torch.func import vmap

from carla_imitation_learning_tpu_torch.sim import prng


@dataclasses.dataclass
class Trial:
    trial_id: int
    config: dict
    metrics: dict
    checkpoint_path: str | None = None
    error: str | None = None  # traceback of a failed trial (the sweep continues)

    @property
    def failed(self) -> bool:
        return self.error is not None


def grid_space(space: Mapping[str, Sequence[Any]]) -> list[dict]:
    keys = list(space.keys())
    return [dict(zip(keys, combo)) for combo in itertools.product(*space.values())]


def sample_space(space: Mapping[str, Any], num_samples: int, seed: int = 0) -> list[dict]:
    """Random search: values may be sequences (choice) or (lo, hi) tuples of
    floats (log-uniform when both positive)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_samples):
        cfg = {}
        for k, v in space.items():
            if isinstance(v, tuple) and len(v) == 2 and all(
                    isinstance(x, (int, float)) for x in v):
                lo, hi = float(v[0]), float(v[1])
                if lo > 0 and hi > 0:
                    cfg[k] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
                else:
                    cfg[k] = float(rng.uniform(lo, hi))
            else:
                cfg[k] = v[rng.integers(len(v))]
        out.append(cfg)
    return out


def tune_run(
    trainable: Callable[[dict], dict],
    space: Mapping[str, Any] | None = None,
    trial_configs: Sequence[dict] | None = None,
    num_samples: int = 4,
    metric: str = "mean_accuracy",
    mode: str = "max",
    seed: int = 0,
    results_dir: str | None = None,
    checkpoint_fn: Callable[[int, dict], str] | None = None,
    max_concurrent: int = 1,
) -> tuple[Trial, list[Trial]]:
    """Run ``trainable(config) -> metrics`` per trial → (best, all trials in
    order). ``trial_configs`` (an explicit grid) overrides sampling
    ``space``. A raising trainable gives a failed ``Trial`` (``error`` = its
    traceback) and the sweep continues; only a sweep whose every trial fails
    raises. ``max_concurrent > 1`` runs the trials on a thread pool, so the
    trainable must share no mutable state between trials: its own loader
    forks (``DeviceDataset.fork``) and generators, and nothing drawn from
    torch's global generator."""
    if trial_configs is None:
        if space is None:
            raise ValueError("need space or trial_configs")
        trial_configs = sample_space(space, num_samples, seed)

    def run_one(i_tc):
        i, tc = i_tc
        try:
            metrics = trainable(dict(tc))
            ckpt = checkpoint_fn(i, metrics) if checkpoint_fn else None
            return Trial(i, dict(tc), dict(metrics), ckpt)
        except Exception:  # noqa: BLE001 — a failed trial is recorded, the sweep goes on
            return Trial(i, dict(tc), {}, None, error=traceback.format_exc())

    if max_concurrent > 1 and len(trial_configs) > 1:
        with ThreadPoolExecutor(max_workers=max_concurrent) as pool:
            trials = list(pool.map(run_one, enumerate(trial_configs)))
    else:
        trials = [run_one(x) for x in enumerate(trial_configs)]
    ok = [t for t in trials if not t.failed]
    if not ok:
        raise RuntimeError("every trial failed; first error:\n" + (trials[0].error or ""))
    sign = -1.0 if mode == "max" else 1.0
    best = min(ok, key=lambda t: sign * float(t.metrics.get(metric, float("inf") * sign)))
    if results_dir:
        p = Path(results_dir)
        p.mkdir(parents=True, exist_ok=True)
        (p / "trials.json").write_text(json.dumps(
            [dataclasses.asdict(t) for t in trials], indent=1, default=str))
    return best, trials


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensor leaves of pytrees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def trial_generators(key: torch.Tensor, n: int) -> list[torch.Generator]:
    """One CPU generator per trial: trial i's seed is the two words of
    ``prng.split(key, n)[i]`` read as one 64-bit number (the keys the JAX
    package hands its ``jax.vmap(init_fn)``)."""
    keys = prng.split(key.cpu(), n).tolist()
    return [torch.Generator().manual_seed((hi << 32) | lo) for hi, lo in keys]


def init_trials(init_fn: Callable, hparams: torch.Tensor, key: torch.Tensor):
    """``init_fn(generator, h)`` for every trial, one at a time, each from
    its own ``trial_generators`` generator, stacked on a leading trial axis
    (as ``torch.func.stack_module_state`` stacks modules)."""
    gens = trial_generators(key, hparams.shape[0])
    states = [init_fn(g, h) for g, h in zip(gens, hparams)]
    return tree_map(lambda *xs: torch.stack(xs), *states)


def vmap_sweep(
    init_fn: Callable[[torch.Generator, torch.Tensor], Any],
    train_fn: Callable[[Any, torch.Tensor], tuple[Any, dict]],
    hparam_values: torch.Tensor,
    key: torch.Tensor,
) -> tuple[Any, dict]:
    """Vectorized sweep: ``train_fn(state, h) -> (state, metrics)`` runs as
    one ``torch.func.vmap`` over the trial axis of ``hparam_values`` and the
    stacked states, so every trial trains in the same launches.

    ``torch.func.vmap`` takes no explicit ``torch.Generator`` inside the
    mapped function, so unlike the JAX package's ``jax.vmap(init_fn)`` the
    trials are initialized outside the map, one at a time, each by
    ``init_fn(generator, h)`` from its own generator (``init_trials``, from
    ``key``), and only the training is vmapped.

    → stacked (states, metrics): trial i is ``x[i]`` of every leaf."""
    states = init_trials(init_fn, hparam_values, key)
    return vmap(train_fn)(states, hparam_values)


def exploit_explore(states, h: torch.Tensor, scores: torch.Tensor, key: torch.Tensor,
                    n_exploit: int, sign: float = 1.0,
                    perturb: tuple[float, float] = (0.8, 1.25)):
    """Truncation selection on the device: the members sorted by ``sign ·
    scores`` (a stable sort, worst first, ties kept in member order); the
    ``n_exploit`` worst take the states and hyperparameters of the
    ``n_exploit`` best (the k-th of the sorted order copies the k-th of the
    last ``n_exploit``, as the JAX package pairs them), and each replaced member's
    hyperparameters are multiplied by ``perturb[1]`` where a draw
    ``uniform(key) < 0.5`` (JAX's ``bernoulli(key, 0.5)``), else by
    ``perturb[0]``. → (states, h, src), ``src[i]`` the member that member i
    now copies."""
    p = scores.shape[0]
    order = torch.argsort(sign * scores, stable=True)
    members = torch.arange(p, device=scores.device)
    src = members.clone()
    src[order[:n_exploit]] = order[p - n_exploit:]
    states = tree_map(lambda x: x.index_select(0, src), states)
    h_src = h.index_select(0, src)
    up = prng.uniform(key.to(h.device), tuple(h_src.shape)) < 0.5
    factors = torch.where(up, perturb[1], perturb[0]).to(h_src.dtype)
    replaced = (src != members).reshape((p,) + (1,) * (h_src.dim() - 1))
    return states, torch.where(replaced, h_src * factors, h_src), src


def pbt_run(
    init_fn: Callable[[torch.Generator, torch.Tensor], Any],
    train_fn: Callable[[Any, torch.Tensor], tuple[Any, dict]],
    hparam_init: torch.Tensor,
    key: torch.Tensor,
    metric: str = "score",
    mode: str = "max",
    n_generations: int = 5,
    exploit_frac: float = 0.25,
    perturb: tuple[float, float] = (0.8, 1.25),
):
    """Population Based Training over a vmapped population (Jaderberg et
    al. 2017, truncation selection). ``hparam_init`` is (P,) or (P, K) on
    the device the population trains on; ``key`` a threefry key
    (``prng.key(seed)``). The members are initialized as ``vmap_sweep``
    initializes trials, from ``key``; every generation splits the key in
    three (carry, segment, explore) as the JAX package does, trains one
    segment (``vmap(train_fn)``) and, before every generation but the
    last, runs ``exploit_explore`` on the segment's ``metric`` with the
    explore key.

    → (states, hparams, history): history is a list of per-generation
    ``{"generation", metric, "hparams"}`` numpy snapshots (one host fetch a
    generation)."""
    p = hparam_init.shape[0]
    n_exploit = max(1, int(p * exploit_frac))
    sign = 1.0 if mode == "max" else -1.0
    states = init_trials(init_fn, hparam_init, key)
    segment = vmap(train_fn)
    h = hparam_init
    history = []
    for g in range(n_generations):
        key, _, k_explore = prng.split(key, 3).unbind(0)
        states, metrics = segment(states, h)
        scores = metrics[metric].to(torch.float32)
        history.append({"generation": g, metric: scores.cpu().numpy().copy(),
                        "hparams": h.cpu().numpy().copy()})
        if g < n_generations - 1:
            states, h, _ = exploit_explore(states, h, scores, k_explore, n_exploit, sign,
                                           perturb)
    return states, h, history

"""Convert the JAX package's pytrees into this package's objects.

Everything here reads its input through ``np.asarray`` on named fields, so
it takes the JAX package's objects (flax params, ``TownMap``, ``WorldState``,
packed spawn pool, ``TriangleSetup``, ``PrimSetup``, rollout carry, train
state) without importing JAX. The port can then run on exactly what the JAX
package computed.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.models.cnn import PolicyCNN
from carla_imitation_learning_tpu_torch.ops.raster_fast import PrimSetup
from carla_imitation_learning_tpu_torch.render.camera import TriangleSetup
from carla_imitation_learning_tpu_torch.sim.town import TownMap
from carla_imitation_learning_tpu_torch.sim.world import WorldState
from carla_imitation_learning_tpu_torch.training.steps import (
    AdamConfig, TrainState, create_train_state,
)

_STATE_INTS = ("ego_route", "agents_route", "peds_crossing", "t", "goal", "rng")


def _tensor(a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype)


def policy_state_dict(params) -> dict:
    """Flax ``PolicyCNN`` params → ``models.cnn.PolicyCNN`` state_dict:
    conv kernels HWIO → OIHW, Dense kernels (in, out) → Linear (out, in)."""
    trunk, head = params["ConvTrunk_0"], params["MLPHead_0"]
    sd = {}
    for i in range(len(trunk)):
        conv = trunk[f"Conv_{i}"]
        sd[f"trunk.convs.{i}.weight"] = _tensor(
            np.transpose(np.asarray(conv["kernel"], np.float32), (3, 2, 0, 1)))
        sd[f"trunk.convs.{i}.bias"] = _tensor(np.asarray(conv["bias"], np.float32))
    for i in range(len(head)):
        dense = head[f"Dense_{i}"]
        sd[f"head.layers.{i}.weight"] = _tensor(np.asarray(dense["kernel"], np.float32).T)
        sd[f"head.layers.{i}.bias"] = _tensor(np.asarray(dense["bias"], np.float32))
    return sd


_TRANSFER_DTYPES = {"transfer_route": torch.int64, "transfer_s": torch.float32,
                    "transfer_valid": torch.bool}


def town_from_jax(town) -> TownMap:
    """JAX ``TownMap`` → port ``TownMap`` (CPU tensors), with its turn-fan
    tables when it has them. Navigation tables (goal-directed routes) raise:
    they wait for ROADMAP Queue 1 item 6."""
    if getattr(town, "nav_slot", None) is not None:
        raise NotImplementedError(
            "navigation tables are not ported yet (ROADMAP Queue 1, item 6)")
    fields = {}
    for f in dataclasses.fields(TownMap):
        a = getattr(town, f.name)
        if f.name in ("lanes", "lane_width") or a is None:
            continue
        fields[f.name] = _tensor(a, _TRANSFER_DTYPES.get(f.name, torch.float32))
    return TownMap(**fields, lanes=int(town.lanes), lane_width=float(town.lane_width))


def world_state_from_jax(state) -> WorldState:
    """JAX ``WorldState`` (batched over envs, or a single env) → port
    ``WorldState`` with a leading env axis. Integer leaves become int64; the
    uint32 ``rng`` key pair keeps its values in int64."""
    single = np.asarray(state.ego_yaw).ndim == 0
    fields = {}
    for f in dataclasses.fields(WorldState):
        a = np.asarray(getattr(state, f.name))
        if single:
            a = a[None]
        dtype = torch.int64 if f.name in _STATE_INTS else torch.float32
        fields[f.name] = _tensor(a.astype(np.int64) if dtype == torch.int64 else a, dtype)
    return WorldState(**fields)


def spawn_pool_from_jax(pool) -> torch.Tensor:
    """The packed pool of ``rollout_spawn_pool``/``pack_spawn_pool`` (the
    (packed, metas, treedef) tuple or the packed matrix alone) → (size, D)
    float32 tensor; both packages use the same layout."""
    packed = pool[0] if isinstance(pool, tuple) else pool
    return _tensor(packed, torch.float32)


def _batched_getter(obj):
    """``get(name, dtype)`` reading field ``name`` of a JAX pytree with a
    leading env axis (added for a single env); None stays None."""
    single = np.asarray(obj.valid).ndim == 1

    def get(name, dtype):
        a = getattr(obj, name)
        if a is None:
            return None
        a = np.asarray(a)
        return _tensor(a[None] if single else a, dtype)

    return get


def setup_from_jax(setup) -> TriangleSetup:
    """JAX ``TriangleSetup`` (batched or a single env) → port
    ``TriangleSetup`` with a leading env axis, optional rows included."""
    get = _batched_getter(setup)
    return TriangleSetup(
        edges=get("edges", torch.float32), znum=get("znum", torch.float32),
        colors=get("colors", torch.float32), classes=get("classes", torch.int64),
        valid=get("valid", torch.bool), bbox=get("bbox", torch.float32),
        zmin=get("zmin", torch.float32), unum=get("unum", torch.float32),
        vnum=get("vnum", torch.float32), zinv=get("zinv", torch.float32),
        pair_ok=get("pair_ok", torch.bool))


def prims_from_jax(prims) -> PrimSetup:
    """JAX ``PrimSetup`` (``fuse_prims``' output, batched or a single env)
    → port ``PrimSetup`` with a leading env axis."""
    get = _batched_getter(prims)
    return PrimSetup(
        edges=get("edges", torch.float32), zinv=get("zinv", torch.float32),
        luma=get("luma", torch.float32), valid=get("valid", torch.bool),
        bbox=get("bbox", torch.float32), zmin=get("zmin", torch.float32))


def carry_from_jax(carry):
    """JAX rollout carry (states, framebuf, just_reset) → port carry."""
    states, framebuf, just_reset = carry[:3]
    return (world_state_from_jax(states), _tensor(framebuf, torch.uint8),
            _tensor(just_reset, torch.bool))


def _field(node, name: str):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _adam_state(node):
    """The first node of an optax state tree that carries Adam's ``count``,
    ``mu`` and ``nu`` (``ScaleByAdamState`` inside any chain, or its dict
    form in a checkpoint restored without a template)."""
    if isinstance(node, dict):
        if {"count", "mu", "nu"} <= set(node):
            return node
        return None
    if all(hasattr(node, k) for k in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, tx: AdamConfig, dtype: torch.dtype = torch.float32,
                         device: str | torch.device = "cpu") -> TrainState:
    """JAX ``TrainState`` of a ``PolicyCNN`` (optax Adam, optionally behind
    a clip) → port ``TrainState`` on ``device``: the params, Adam's ``mu``
    and ``nu`` through the same transposes as the params, its ``count`` as
    each parameter's Adam step and as the schedule's step, and the EMA
    shadow. ``tx`` is the port's optimizer config for the same run, so a
    step taken from here continues the JAX run."""
    params = state.params
    obs_size = np.asarray(params["ConvTrunk_0"]["Conv_0"]["kernel"]).shape[2]
    head = params["MLPHead_0"]
    n_actions = np.asarray(head[f"Dense_{len(head) - 1}"]["kernel"]).shape[1]
    model = PolicyCNN(obs_size=obs_size, n_actions=n_actions, dtype=dtype)
    model.load_state_dict(policy_state_dict(params))
    out = create_train_state(model, tx, ema_decay=float(state.ema_decay), device=device)
    adam = _adam_state(state.opt_state)
    count = int(np.asarray(_field(adam, "count")))
    mu, nu = policy_state_dict(_field(adam, "mu")), policy_state_dict(_field(adam, "nu"))
    opt = out.optimizer.state_dict()
    opt["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]}
                    for i, (name, _) in enumerate(model.named_parameters())}
    out.optimizer.load_state_dict(opt)
    out.step = count
    if state.ema_params is not None:
        out.ema.load_state_dict(policy_state_dict(state.ema_params))
    return out


def checkpoint_from_jax(payload: dict) -> dict:
    """A JAX ``PolicyCNN`` checkpoint, restored as numpy arrays (``{"params",
    "opt_state", "step"[, "ema_params"]}``, e.g. Orbax's templateless
    restore), → this package's checkpoint payload (``TrainState.payload()``:
    state_dicts of the model, Adam and the EMA shadow, and the step), for
    ``utils.checkpoint.save_pytree``. Adam's moments and count come through
    ``train_state_from_jax``; the learning rate is set from the schedule at
    every step, so the one stored here is a placeholder."""
    ema = payload.get("ema_params")
    jstate = SimpleNamespace(params=payload["params"], opt_state=payload["opt_state"],
                             ema_params=ema, ema_decay=0.5 if ema is not None else 0.0)
    state = train_state_from_jax(jstate, AdamConfig(schedule=lambda count: 1e-3))
    out = state.payload()
    out["step"] = int(np.asarray(payload["step"]))
    return out

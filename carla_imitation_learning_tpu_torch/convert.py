"""Convert the JAX package's pytrees into this package's objects.

Everything here reads its input through ``np.asarray`` on named fields, so
it takes the JAX package's objects (flax params, ``TownMap``, ``WorldState``,
packed spawn pool, ``TriangleSetup``, ``PrimSetup``, rollout carry) without importing JAX.
The port can then run on exactly what the JAX package computed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.ops.raster_fast import PrimSetup
from carla_imitation_learning_tpu_torch.render.camera import TriangleSetup
from carla_imitation_learning_tpu_torch.sim.town import TownMap
from carla_imitation_learning_tpu_torch.sim.world import WorldState

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


def town_from_jax(town) -> TownMap:
    """JAX ``TownMap`` → port ``TownMap`` (CPU tensors)."""
    if getattr(town, "transfer_route", None) is not None or \
            getattr(town, "nav_slot", None) is not None:
        raise NotImplementedError("turn-fan and navigation tables are not ported yet")
    tensors = {f.name: _tensor(getattr(town, f.name), torch.float32)
               for f in dataclasses.fields(TownMap)
               if f.name not in ("lanes", "lane_width")}
    return TownMap(**tensors, lanes=int(town.lanes), lane_width=float(town.lane_width))


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

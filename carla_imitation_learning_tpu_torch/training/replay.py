"""Deterministic episode recorder and replayer (CARLA's recorder, on the card).

The simulator is a pure function of the fleet's initial ``WorldState`` and
the controls it executes each step, and every rollout trajectory logs the
executed steer, throttle and brake (``make_rollout``, after noise and the
shield). So a record is the initial state, a (T, B, 3) control trace and the
configs that rebuild the world, a few KB for a whole fleet, and a replay
steps the same ``pick_fresh_packed`` → ``step_env`` composition as the
rollout with the same spawn pool:

- the state trajectory (auto-resets, collisions, light phases) comes back
  bit for bit on the device that recorded it;
- rendering is apart from the dynamics, so a replay may render with any
  ``RenderConfig`` and rig camera, for example one env of a 1024-env fleet
  at 256² in RGB with its class plane; envs are independent, and
  ``select_envs`` cuts a record down to the ones of interest.

File format, shared with the JAX package: one ``.npz`` holding
``state0_<field>`` arrays for the initial state (in the JAX package's
dtypes: float32, int32 for the integer fields, uint32 for ``rng``), a
``controls`` (T, B, 3) float32 array and a ``meta`` JSON string with the
``SimParams``, ``make_town`` keyword and ``RenderConfig`` dicts. Records of
either package load in the other. The JAX package's render dict also holds
``backend`` and ``semantic``, which the port's ``RenderConfig`` lacks and
``render_config`` ignores.

A rollout that auto-resets draws fresh states from its spawn pool, so a
record replays exactly with the pool of the run that wrote it: the default
is ``rollout_spawn_pool``, and a JAX package's record replays through resets
with its pool passed as ``spawn_pool`` (``convert.spawn_pool_from_jax``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.device import map_tensors, resolve_device
from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig, make_renderer
from carla_imitation_learning_tpu_torch.sim.town import make_town
from carla_imitation_learning_tpu_torch.sim.world import (
    SimParams, VehicleControl, WorldState, pick_fresh_packed, sensor_vector, step_env,
    traffic_light_state,
)
from carla_imitation_learning_tpu_torch.training.closed_loop import rollout_spawn_pool

_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(WorldState))
# the JAX package's integer dtypes of the record's fields; the rest float32
_INT32_FIELDS = ("ego_route", "agents_route", "peds_crossing", "t", "goal")
_UINT32_FIELDS = ("rng",)
# RenderConfig fields of the JAX package that the port has no use for
_JAX_ONLY_RENDER = ("backend", "semantic")


@dataclasses.dataclass
class EpisodeRecord:
    """A recorded fleet episode: the initial state, the executed control
    trace and the configs that rebuild the same world."""

    states0: WorldState          # batched (B, ...) initial fleet state, on the CPU
    controls: np.ndarray         # (T, B, 3) float32: steer, throttle, brake
    sim: dict                    # SimParams fields
    town: dict                   # make_town(**town) keywords
    render: dict                 # RenderConfig fields at record time
    meta: dict                   # free form (driver, seed, notes)

    @property
    def n_steps(self) -> int:
        return int(self.controls.shape[0])

    @property
    def n_envs(self) -> int:
        return int(self.controls.shape[1])


def record_from_rollout(states0: WorldState, traj: dict, *, params: SimParams,
                        town_kwargs: dict, rcfg: RenderConfig,
                        meta: dict | None = None) -> EpisodeRecord:
    """A record of a ``make_rollout`` run: the carry's initial states (the
    rollout builds new states each step and never writes into them) and the
    trajectory's executed steer, throttle and brake (T, B)."""
    controls = np.stack([traj[k].cpu().numpy().astype(np.float32)
                         for k in ("steer", "throttle", "brake")], axis=-1)
    return EpisodeRecord(states0=states0.to("cpu"), controls=controls,
                         sim=dataclasses.asdict(params), town=dict(town_kwargs),
                         render=dataclasses.asdict(rcfg), meta=dict(meta or {}))


def select_envs(rec: EpisodeRecord, idx) -> EpisodeRecord:
    """The record of envs ``idx`` (an int or an index array) alone: envs
    are independent, so any subset replays by itself."""
    idx = np.atleast_1d(np.asarray(idx, np.int64))
    rows = torch.from_numpy(idx)
    return dataclasses.replace(rec, states0=map_tensors(rec.states0, lambda a: a[rows]),
                               controls=rec.controls[:, idx])


def _jax_dtype(name: str) -> type:
    if name in _INT32_FIELDS:
        return np.int32
    return np.uint32 if name in _UINT32_FIELDS else np.float32


def save_record(path, rec: EpisodeRecord) -> str:
    """Write ``rec`` as the shared ``.npz`` (the state in the JAX package's
    dtypes); → the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"state0_{n}": getattr(rec.states0, n).cpu().numpy().astype(_jax_dtype(n))
              for n in _STATE_FIELDS}
    meta = {"sim": rec.sim, "town": rec.town, "render": rec.render, "meta": rec.meta,
            "version": 1}
    np.savez_compressed(path, controls=np.asarray(rec.controls, np.float32),
                        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                        **arrays)
    return str(path)


def load_record(path) -> EpisodeRecord:
    """Read a record written by either package: integer fields become
    int64 (``rng`` keeps its uint32 values), the rest float32; a record
    without ``goal`` (older than goal navigation) drives free, goal −1."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        controls = np.asarray(z["controls"], np.float32)
        fields = {}
        for n in _STATE_FIELDS:
            if f"state0_{n}" in z:
                a = z[f"state0_{n}"]
            elif n == "goal":
                a = np.full((controls.shape[1],), -1, np.int64)
            else:
                raise KeyError(f"record lacks WorldState field {n!r}")
            dtype = np.float32 if _jax_dtype(n) is np.float32 else np.int64
            fields[n] = torch.from_numpy(np.asarray(a).astype(dtype))
    return EpisodeRecord(states0=WorldState(**fields), controls=controls, sim=meta["sim"],
                         town=meta["town"], render=meta["render"], meta=meta["meta"])


def render_config(fields: dict) -> RenderConfig:
    """``RenderConfig`` from a record's render dict (or one patched by an
    override); the JAX package's ``backend`` and ``semantic`` are ignored,
    any other unknown field raises."""
    return RenderConfig(**{k: v for k, v in fields.items() if k not in _JAX_ONLY_RENDER})


def rebuild_world(rec: EpisodeRecord):
    """(params, town) of the recording run; the town on the CPU."""
    return SimParams(**rec.sim), make_town(**rec.town)


def make_replay(params: SimParams, town, rcfg: RenderConfig | None, camera: str = "camera",
                spawn_pool: torch.Tensor | None = None,
                device: str | torch.device = "cuda"):
    """→ ``replay_fn(states0, controls) -> (final_states, out)``.

    Steps the recorded controls (T, B, 3) through the composition
    ``make_rollout`` uses (the spawn pool, default ``rollout_spawn_pool``,
    → ``pick_fresh_packed`` → ``step_env``), so the state trajectory repeats
    bit for bit on the device that recorded it. ``out`` stacks per step the
    sensors (T, B, 3), traffic (T, B), the step's speed, collision, offroad,
    done and red-light flags and, unless ``rcfg`` is None, every plane the
    renderer (rig camera ``camera``) gives for the state before the step."""
    dev = resolve_device(device)
    town = town.to(dev)
    pool = (rollout_spawn_pool(params, town) if spawn_pool is None else spawn_pool).to(dev)
    render = (None if rcfg is None
              else make_renderer(params, town, rcfg, device=dev, camera=camera))

    @torch.no_grad()
    def replay_fn(states0: WorldState, controls):
        states = states0.to(dev)
        controls = torch.as_tensor(np.asarray(controls, np.float32)).to(dev)
        outs = []
        for ctrl in controls:
            out = {"sensor": sensor_vector(params, states),
                   "traffic": traffic_light_state(params, town, states)}
            if render is not None:
                out.update(render(states))
            control = VehicleControl(steer=ctrl[:, 0], throttle=ctrl[:, 1], brake=ctrl[:, 2])
            states, info = step_env(params, town, states, control,
                                    pick_fresh_packed(pool, params, states))
            out.update({k: info[k] for k in ("speed", "collision", "offroad", "done",
                                             "red_light")})
            outs.append(out)
        return states, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return replay_fn


def replay_record(rec: EpisodeRecord, *, render_override: dict | None = None,
                  camera: str = "camera", render: bool = True,
                  spawn_pool: torch.Tensor | None = None,
                  device: str | torch.device = "cuda") -> dict:
    """Replay a record end to end → ``make_replay``'s stacked per-step dict.
    ``render_override`` patches ``RenderConfig`` fields over the recorded
    ones (a new resolution, RGB, weather: the new spectator camera);
    ``render=False`` replays the dynamics alone."""
    params, town = rebuild_world(rec)
    rcfg = render_config({**rec.render, **(render_override or {})}) if render else None
    replay_fn = make_replay(params, town, rcfg, camera, spawn_pool=spawn_pool, device=device)
    return replay_fn(rec.states0, rec.controls)[1]

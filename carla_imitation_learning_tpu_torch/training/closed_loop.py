"""Closed-loop fleet rollout and driving evaluation.

``make_rollout`` builds the policy-in-the-loop fleet rollout: sim state →
fast grayscale render (kernel B) → uint8 4-frame window → policy forward →
discrete action → sim step with auto-resets from the packed spawn pool. The
JAX package runs it as one ``lax.scan``; here each step is a handful of
batched tensor ops on the device and the loop runs on the host.
``evaluate_policy`` turns a rollout into driving metrics, and
``evaluate_routes`` scores goal-directed (A→B) driving on a town with nav
tables (``assign_goals`` gives each env its goal). With
``record_semantic`` the rollout also records the driving view's per-pixel
class ids, rendered on the exact path (kernel A, textured when the config
asks for textures), the supervision stream of segmentation collection.
``cameras`` turns on surround view: every rig view renders each step and
the frame window stacks them camera-minor. ``collect_dataset`` packs a
rollout into a ``FrameStore`` for training;
with a ``NoiseConfig`` it perturbs the executed steering with triangular
impulses while the labels stay the clean driver's, and with a policy it is
the DAgger aggregation step (``dagger_iteration``). A ``ShieldConfig``
(``training.shield``) puts the emergency-brake layer on the executed
control, and ``lidar_beams`` records a planar range scan
(``render.lidar``) of every step. ``collect_multicamera`` renders one
expert trajectory from a whole camera rig on the exact path (kernel A).

Data parallel (``mesh=`` on ``make_rollout``, ``evaluate_policy`` and
``evaluate_routes``): every rank draws the global fleet and keeps its rows
of the env axis, renders and steps them (kernel B on each rank's rows);
the noise schedule is drawn for the global fleet from an all-reduced seed
and sliced; the metrics are sums and counts all-reduced once per rollout.
A step itself all-reduces nothing.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.data.actions import (
    continuous_to_discrete, control_to_discrete_label, discrete_to_continuous,
)
from carla_imitation_learning_tpu_torch.data.frame_log import StateLog
from carla_imitation_learning_tpu_torch.data.pipeline import FrameStore
from carla_imitation_learning_tpu_torch.device import resolve_device
from carla_imitation_learning_tpu_torch.ops.raster import rasterize_exact_luma
from carla_imitation_learning_tpu_torch.parallel.mesh import shard_batch
from carla_imitation_learning_tpu_torch.render.lidar import make_lidar
from carla_imitation_learning_tpu_torch.render.pipeline import (
    RenderConfig, make_renderer, make_scene_setup,
)
from carla_imitation_learning_tpu_torch.sim.town import TownMap
from carla_imitation_learning_tpu_torch.sim.world import (
    SimParams, VehicleControl, autopilot_control, make_spawn_pool,
    navigation_command, pick_fresh_packed, reset_env, sensor_vector, step_env,
    traffic_light_state,
)
from carla_imitation_learning_tpu_torch.training.shield import ShieldConfig, make_shield
from carla_imitation_learning_tpu_torch.utils.profiling import span

SPAWN_POOL_SEED = 0x5EED
SPAWN_POOL_SIZE = 1024


def update_framebuf(framebuf: torch.Tensor, gray: torch.Tensor,
                    just_reset: torch.Tensor) -> torch.Tensor:
    """Slide the per-env frame window (B, H, W, fs); envs that auto-reset on
    the previous step get their window refilled with the fresh view, so an
    observation never blends two episodes. gray (B, H, W), just_reset (B,).

    Surround view: gray (B, H, W, K) holds the step's K rig views and the
    window is (B, H, W, fs·K), channel t·K + c (time-major, camera-minor,
    the layout ``data.pipeline.gather_windows`` gives stacked stores): the
    oldest K channels drop out and the new K come in."""
    if gray.dim() == 3:
        gray = gray[..., None]
    b, h, w, k = gray.shape
    fresh = gray[..., None, :]                                  # (B, H, W, 1, K)
    window = framebuf.view(b, h, w, -1, k)
    return torch.where(just_reset.view(b, 1, 1, 1, 1), fresh,
                       torch.cat([window[..., 1:, :], fresh], -2)).view(b, h, w, -1)


def control_from_discrete(action: torch.Tensor) -> VehicleControl:
    steer, throttle, brake = discrete_to_continuous(action)
    return VehicleControl(steer=steer, throttle=throttle, brake=brake)


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Collection noise (the CIL recovery-data trick): triangular steering
    impulses added to the EXECUTED steer, while ``expert_action``, the
    policy's ``action`` and the state-log steer stay the clean driver's.

    prob: per-step, per-env chance that an impulse starts; duration: its
    length in steps (a triangle over ``max(duration, 3)`` points);
    magnitude: its largest |steer| offset, also the clip of overlapping
    impulses; seed: the schedule's seed, combined with the fleet's state so
    each collection draws its own schedule."""

    prob: float = 0.005
    duration: int = 20
    magnitude: float = 0.6
    seed: int = 0


def noise_draws(generator: torch.Generator, n_steps: int, n_envs: int,
                ncfg: NoiseConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The random part of a noise schedule, (T, B) each on the generator's
    device: impulse starts (bool, chance ``prob``), signs (±1.0) and peak
    fractions uniform in [0.3, 1)."""
    shape = (n_steps, n_envs)
    starts = torch.rand(shape, generator=generator) < ncfg.prob
    sign = torch.where(torch.rand(shape, generator=generator) < 0.5, 1.0, -1.0)
    mag = 0.3 + 0.7 * torch.rand(shape, generator=generator)
    return starts, sign, mag


def noise_shape(starts: torch.Tensor, sign: torch.Tensor, mag: torch.Tensor,
                ncfg: NoiseConfig) -> torch.Tensor:
    """(T, B) steering noise from its draws: the signed impulse train
    convolved causally with a triangle of ``max(duration, 3)`` points (the
    first T terms of the full convolution), clipped to ±magnitude. Summed
    one tap at a time in float32, so every device gives the same values."""
    train = starts.to(torch.float32) * sign.to(torch.float32) * mag.to(torch.float32) \
        * ncfg.magnitude
    n_steps = train.shape[0]
    tri = 1.0 - torch.linspace(-1.0, 1.0, max(int(ncfg.duration), 3)).abs()
    conv = torch.zeros_like(train)
    for j in range(min(len(tri), n_steps)):
        conv[j:] += tri[j] * train[:n_steps - j]
    return conv.clamp(-ncfg.magnitude, ncfg.magnitude)


def _noise_schedule(generator: torch.Generator, n_steps: int, n_envs: int,
                    ncfg: NoiseConfig) -> torch.Tensor:
    """(T, B) steering-noise schedule: ``noise_shape`` of ``noise_draws``."""
    return noise_shape(*noise_draws(generator, n_steps, n_envs, ncfg), ncfg)


def noise_generator(ncfg: NoiseConfig, states, mesh=None) -> torch.Generator:
    """A CPU generator seeded from ``ncfg.seed`` and the sum of the fleet's
    per-env keys (one host read), so collections from different fleet
    states draw different schedules and a repeat draws the same one. Both
    are hashed into the 32 bits the CPU generator's seed keeps. Under a
    ``mesh`` the sum is over the global fleet (all-reduced over ``data``)."""
    key_sum = states.rng.sum().reshape(1)
    if mesh is not None:
        mesh.all_reduce_(key_sum)
    key_sum = int(key_sum)
    seed = np.random.SeedSequence([int(ncfg.seed), key_sum]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(seed))


def rollout_spawn_pool(params: SimParams, town: TownMap) -> torch.Tensor:
    """The packed auto-reset spawn pool a rollout draws from by default
    (fixed seed and size, on the town's device)."""
    gen = torch.Generator().manual_seed(SPAWN_POOL_SEED)
    return make_spawn_pool(params, town, gen, SPAWN_POOL_SIZE)


def _quantize(gray: torch.Tensor) -> torch.Tensor:
    return torch.clamp(gray * 255.0 + 0.5, 0, 255).to(torch.uint8)


def make_rollout(params: SimParams, town: TownMap, rcfg: RenderConfig,
                 policy_fn: Callable | None, frame_skip: int = 4,
                 spawn_pool: torch.Tensor | None = None,
                 device: str | torch.device = "cuda",
                 record_semantic: bool = False, noise: NoiseConfig | None = None,
                 control_space: str = "discrete",
                 policy_rng: torch.Generator | None = None,
                 shield: ShieldConfig | None = None, lidar_beams: int = 0,
                 policy_carry_init: Callable | None = None,
                 cameras: tuple = ("camera",), mesh=None):
    """Build (init_fn, rollout_fn) for a fleet.

    ``policy_fn(obs)`` maps the NHWC float window (B, H, W, frame_skip) in
    [0, 1] to (B,) integer actions, or to ``(actions, extra)`` with a (B,)
    per-env scalar (an ensemble's disagreement) logged as
    ``traj["policy_extra"]``; None drives with the autopilot expert. A
    policy of two parameters is called ``policy_fn(obs, extras)`` with
    ``extras = {"speed": (B,), "command": (B,) navigation command, "sensor":
    (B, 3)}`` of the state before the step (and ``"rng"``, the
    ``policy_rng`` generator, when one is given); one of three parameters
    also gets ``rollout_fn``'s ``policy_params``.
    ``policy_carry_init`` (``n_envs -> tensor or tuple of tensors``) makes
    the policy recurrent: it is called ``policy_fn(obs, h) -> (actions,
    h')`` with its state riding the carry, and ``h`` is set back to
    ``policy_carry_init``'s value for every env whose ``just_reset`` is set
    (a fresh episode never starts from a crashed car's memory); a recurrent
    policy gets no extras and emits discrete actions.
    ``control_space="continuous"`` takes the policy's output as (B, 2)
    float controls, clipped to [-1, 1]: steer, and a signed acceleration
    executed as throttle max(a, 0) and brake max(−a, 0);
    ``traj["action"]`` then holds ``control_to_discrete_label`` of the
    executed control.
    ``noise`` adds a ``NoiseConfig`` schedule, drawn once per
    ``rollout_fn`` call, to the executed steer (clipped to [-1, 1]);
    ``traj["clean_steer"]`` then holds the steer before the noise, and the
    labels and ``traj["action"]`` stay clean.
    ``shield`` (a ``training.shield.ShieldConfig``) cuts throttle and
    applies full brake on the executed control, before the steer noise,
    when the forward fan sees a collision coming; ``traj["shield"]`` (T, B)
    bool logs each intervention, and the labels stay the policy's own.
    ``lidar_beams`` > 0 adds ``traj["lidar"]`` (T, B, lidar_beams): the
    360° range scan (60 m) of the state before each step.
    ``spawn_pool`` is a packed (size, D) pool (``sim.world.pack_spawn_pool``
    layout, so the JAX package's pool can be passed in); None builds the
    default one. The renderer is forced onto the fast grayscale kernel with
    a 2-pixel LOD unless ``rcfg.lod_px`` says otherwise. ``record_semantic``
    adds ``traj["semantic"]`` (T, B, H, W) uint8: the class ids of the
    driving view, from a second scene setup of the same state rendered on
    the exact luma path (``replace(rcfg, fast=False, rgb=False)``).
    ``cameras`` is the observation rig (``render.camera.CAMERA_PRESETS``
    names), its first entry the driving view that ``traj["gray"]`` and the
    semantic stream record. More than one camera is surround view: every
    view renders each step (kernel B once a view), the window holds
    frame_skip·K channels, time-major and camera-minor
    (``update_framebuf``), and ``traj["views"]`` (T, B, H, W, K) uint8 logs
    all of them. One camera runs the single-view program.
    ``mesh`` (``parallel.mesh``) shards the env axis over ``data``:
    ``init_fn`` draws the global fleet of ``n_envs`` and keeps this rank's
    rows, so the carry and the trajectory are the rank's; the noise
    schedule is the global one's columns. A policy that draws from
    ``policy_rng`` (the same generator on every rank) must draw for the
    global fleet and keep its rows, as ``rl.make_actor(mesh=)`` does.

    ``init_fn(generator, n_envs) -> carry`` with carry = (states, framebuf
    (B, H, W, fs·K) uint8, just_reset (B,) bool[, policy state]);
    ``rollout_fn(carry, n_steps,
    policy_params=None) -> (carry, traj)`` where traj stacks per-step (T, B,
    ...) tensors."""
    if control_space not in ("discrete", "continuous"):
        raise ValueError(f"unknown control_space {control_space!r}")
    continuous = control_space == "continuous"
    recurrent = policy_carry_init is not None
    if continuous and recurrent:
        raise NotImplementedError(
            "continuous control_space with a recurrent policy is not wired up: "
            "recurrent policies emit discrete actions")
    n_policy_args = (0 if policy_fn is None or recurrent
                     else len(inspect.signature(policy_fn).parameters))
    dev = resolve_device(device)
    town = town.to(dev)
    rcfg = dataclasses.replace(rcfg, rgb=False, fast=True)
    if rcfg.lod_px < 0.0:
        rcfg = dataclasses.replace(rcfg, lod_px=2.0)
    cameras = tuple(cameras) or ("camera",)
    renders = [make_renderer(params, town, rcfg, device=dev, camera=c) for c in cameras]
    sem_setup = None
    if record_semantic:
        sem_rcfg = dataclasses.replace(rcfg, fast=False, rgb=False)
        sem_setup = make_scene_setup(params, town, sem_rcfg, device=dev, camera=cameras[0])
    pool = (rollout_spawn_pool(params, town) if spawn_pool is None
            else spawn_pool).to(dev)
    shield_apply = None if shield is None else make_shield(town, shield)
    lidar_scan = make_lidar(town, n_beams=lidar_beams) if lidar_beams > 0 else None

    def views_of(states) -> torch.Tensor:
        """(B, H, W, K) uint8: every rig view of the state."""
        if len(renders) == 1:
            return _quantize(renders[0](states)["gray"])[..., None]
        return torch.stack([_quantize(r(states)["gray"]) for r in renders], -1)

    @torch.no_grad()
    def init_fn(generator: torch.Generator, n_envs: int):
        states = reset_env(params, town, generator, n_envs)
        if mesh is not None:   # the global fleet's draws, this rank's rows
            states = shard_batch(mesh, states)
            n_envs = states.t.shape[0]
        framebuf = views_of(states).repeat(1, 1, 1, frame_skip)
        base = (states, framebuf, torch.zeros(n_envs, dtype=torch.bool, device=dev))
        if recurrent:
            return base + (_tree(lambda h: h.to(dev), policy_carry_init(n_envs)),)
        return base

    def run_policy(obs, states, sensors, command, policy_params):
        if n_policy_args < 2:
            return policy_fn(obs)
        extras = {"speed": states.ego_v, "command": command, "sensor": sensors}
        if policy_rng is not None:
            extras["rng"] = policy_rng
        if n_policy_args >= 3:
            return policy_fn(obs, extras, policy_params)
        return policy_fn(obs, extras)

    def one_step(carry, steer_noise, policy_params):
        states, framebuf, just_reset = carry[:3]
        if recurrent:
            pcarry = _tree(lambda h, h0: torch.where(
                just_reset.view((-1,) + (1,) * (h.dim() - 1)), h0.to(dev), h),
                carry[3], policy_carry_init(just_reset.shape[0]))
        views = views_of(states)
        gray_u8 = views[..., 0]
        framebuf = update_framebuf(framebuf, views, just_reset)
        obs = framebuf.to(torch.float32) * (1.0 / 255.0)

        with span("expert"):
            sensors = sensor_vector(params, states)
            traffic = traffic_light_state(params, town, states)
            command = navigation_command(params, town, states)
            expert = autopilot_control(params, town, states)
            expert_action = continuous_to_discrete(
                expert.steer, expert.throttle, expert.brake).to(torch.int64)
        policy_extra = None
        if policy_fn is None:
            control, action = expert, expert_action
        elif recurrent:
            with span("policy"):
                action, pcarry = policy_fn(obs, pcarry)
            action = action.to(torch.int64)
            control = control_from_discrete(action)
        else:
            with span("policy"):
                res = run_policy(obs, states, sensors, command, policy_params)
            if isinstance(res, tuple):
                res, policy_extra = res
            if continuous:
                ctrl = res.to(torch.float32).clamp(-1.0, 1.0)
                control = VehicleControl(steer=ctrl[:, 0], throttle=ctrl[:, 1].clamp(min=0.0),
                                         brake=(-ctrl[:, 1]).clamp(min=0.0))
                action = control_to_discrete_label(control.steer, control.throttle,
                                                   control.brake)
            else:
                action = res.to(torch.int64)
                control = control_from_discrete(action)
        shield_on = None
        if shield_apply is not None:
            control, shield_on = shield_apply(states, control)
        clean_steer = None
        if steer_noise is not None:
            clean_steer = control.steer
            control = dataclasses.replace(
                control, steer=torch.clamp(control.steer + steer_noise, -1.0, 1.0))

        with span("sim"):
            fresh = pick_fresh_packed(pool, params, states)
            new_states, info = step_env(params, town, states, control, fresh)
        # along-route progress this step, masked on resets
        total = town.route_total[states.ego_route]
        raw_ds = torch.remainder(new_states.ego_s - states.ego_s + 0.5 * total,
                                 total) - 0.5 * total
        same = (new_states.ego_route == states.ego_route) & ~info["done"]
        out = {
            "route_ds": torch.where(same, raw_ds, 0.0),
            "gray": gray_u8, "action": action, "expert_action": expert_action,
            "expert_steer": expert.steer,
            "expert_accel": expert.throttle - expert.brake,
            "sensor": sensors, "traffic": traffic, "command": command,
            "collision": info["collision"], "offroad": info["offroad"],
            "done": info["done"], "speed": info["speed"],
            "red_light": info["red_light"], "ran_red": info["ran_red"],
            "arrived": info["arrived"],
            "steer": control.steer, "throttle": control.throttle,
            "brake": control.brake,
        }
        if len(renders) > 1:
            out["views"] = views
        if sem_setup is not None:
            _, sem, _ = rasterize_exact_luma(sem_setup(states), rcfg.height, rcfg.width,
                                             near=rcfg.near, far=rcfg.far)
            out["semantic"] = sem.to(torch.uint8)
        if lidar_scan is not None:
            out["lidar"] = lidar_scan(states)
        if policy_extra is not None:
            out["policy_extra"] = policy_extra
        if clean_steer is not None:
            out["clean_steer"] = clean_steer
        if shield_on is not None:
            out["shield"] = shield_on
        new_carry = (new_states, framebuf, info["done"])
        return (new_carry + (pcarry,) if recurrent else new_carry), out

    @torch.no_grad()
    def rollout_fn(carry, n_steps: int, policy_params=None):
        with span("rollout"):
            schedule = None
            if noise is not None:
                n_envs = carry[0].t.shape[0]
                n_global = n_envs if mesh is None else n_envs * mesh.size()
                schedule = _noise_schedule(noise_generator(noise, carry[0], mesh), n_steps,
                                           n_global, noise)
                if mesh is not None:
                    schedule = schedule[:, mesh.rows(n_global)]
                schedule = schedule.to(dev)
            outs = []
            for t in range(n_steps):
                carry, out = one_step(carry, None if schedule is None else schedule[t],
                                      policy_params)
                outs.append(out)
            return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return init_fn, rollout_fn


def _tree(fn, *trees):
    """``fn`` over the tensors of one policy state, or of parallel tuples
    of them (an LSTM's (c, h))."""
    if isinstance(trees[0], tuple):
        return tuple(_tree(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def assign_goals(carry, goal_ids):
    """Give each env of a rollout carry a navigation goal: ``goal_ids`` (B,)
    indexes ``town.nav_goals`` (``sim.planner.plan_to_goals``); −1 keeps
    that env free-roaming, exactly as without goals."""
    states = carry[0]
    goal = torch.as_tensor(np.asarray(goal_ids), dtype=torch.int64).to(states.goal.device)
    return (states.replace(goal=goal),) + tuple(carry[1:])


def _env_major(x: torch.Tensor) -> np.ndarray:
    """(T, B, ...) → env-major (B·T, ...) on the host."""
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:])).cpu().numpy()


def semantic_stream(traj: dict) -> np.ndarray:
    """Env-major (B·T, H, W) uint8 class ids of the driving view from a
    ``record_semantic`` rollout, frame-aligned with the env-major frame
    stream a collection writes."""
    return _env_major(traj["semantic"])                     # (T, B, H, W)


def extra_view_streams(traj: dict) -> list[np.ndarray]:
    """Env-major (B·T, H, W) uint8 streams of rig views 1..K−1 of a
    surround rollout (``traj["views"]``): the ``extra_frames`` that
    ``DeviceDataset`` stacks camera-minor beside the store's driving view,
    the rollout window's own layout."""
    views = traj["views"]                                    # (T, B, H, W, K)
    return [_env_major(views[..., k]) for k in range(1, views.shape[-1])]


def collect_dataset(params: SimParams, town: TownMap, rcfg: RenderConfig,
                    generator: torch.Generator, n_envs: int = 16, n_steps: int = 256,
                    frame_skip: int = 4, policy_fn: Callable | None = None,
                    noise=None, control_space: str = "discrete", goal_ids=None,
                    cameras: tuple = ("camera",), record_semantic: bool = False,
                    device: str | torch.device = "cuda"):
    """Rollouts → (FrameStore, StateLog, traj): uint8 frames, expert labels
    and sensors, laid out env-major so each env's stream is contiguous.

    With ``policy_fn=None`` the expert drives; with a policy the policy
    drives and the expert labels (the DAgger form). ``store.starts`` marks
    every env stream's first frame and the frame after every auto-reset, so
    a dataset never samples a window across an episode boundary. ``noise``
    (a ``NoiseConfig``) perturbs the executed steer; the state log's steer
    column and the labels stay clean. ``goal_ids`` (B,) makes
    the collection goal-directed on a town with nav tables, so the command
    channel records the planner's turns; ``control_space="continuous"``
    lets a continuous policy drive (labels stay the expert's). ``cameras``
    is the rig (``make_rollout``); its first view fills the store, and with
    more than one ``extra_view_streams(traj)`` gives the others. The
    trajectory stays on the device until one host copy per field."""
    init_fn, rollout_fn = make_rollout(params, town, rcfg, policy_fn, frame_skip,
                                       device=device, record_semantic=record_semantic,
                                       noise=noise, control_space=control_space,
                                       cameras=cameras)
    carry = init_fn(generator, n_envs)
    if goal_ids is not None:
        carry = assign_goals(carry, goal_ids)
    _, traj = rollout_fn(carry, n_steps)

    flat = _env_major
    sensor = flat(traj["sensor"])
    traffic = flat(traj["traffic"])
    state = _state_log(flat(traj.get("clean_steer", traj["steer"])), flat(traj["throttle"]),
                       flat(traj["brake"]), traffic, sensor)
    starts = _episode_starts(flat(traj["done"]), n_envs, n_steps)
    store = FrameStore(
        frames=flat(traj["gray"]),
        actions=flat(traj["expert_action"]).astype(np.int32),
        traffic=traffic.astype(np.int32),
        sensors=sensor.astype(np.float32),
        commands=flat(traj["command"]).astype(np.int32),
        starts=starts,
        controls=np.stack([flat(traj["expert_steer"]).astype(np.float32),
                           flat(traj["expert_accel"]).astype(np.float32)], axis=1),
    )
    return store, state, traj


def _episode_starts(done_flat: np.ndarray, n_envs: int, n_steps: int) -> np.ndarray:
    """The store's episode-start bitmap of an env-major collection: each
    env stream's first frame and the frame after every auto-reset."""
    starts = np.zeros(n_envs * n_steps, bool)
    starts[::n_steps] = True
    starts[1:] |= np.asarray(done_flat, bool)[:-1]
    return starts


def _state_log(steer, throttle, brake, traffic, sensor) -> StateLog:
    """The ``state.csv`` columns of a collection, from its env-major host
    arrays."""
    return StateLog(
        steer=steer.astype(np.float64),
        throttle=throttle.astype(np.float64),
        brake=brake.astype(np.float64),
        trafficlight=traffic.astype(np.float64),
        current_steer=sensor[:, 0].astype(np.float64),
        speed_long=sensor[:, 1].astype(np.float64),
        speed=sensor[:, 2].astype(np.float64),
    )


@torch.no_grad()
def collect_multicamera(params: SimParams, town: TownMap, rcfg: RenderConfig,
                        generator: torch.Generator,
                        cameras: tuple = ("camera", "FL", "FR", "SL", "SR", "RR"),
                        n_envs: int = 8, n_steps: int = 128,
                        device: str | torch.device = "cuda"):
    """One expert trajectory seen from a whole camera rig → (frames
    {camera: env-major (B·T, H, W) uint8}, StateLog, starts (B·T,) bool):
    the multi-camera raw log of the reference's VAE data (FL/FR/RR/SL/SR).

    Every view renders with ``rcfg`` as given (no fast path is forced, so
    the RGB configs take the exact branch, kernel A, with gray = luma). The
    expert drives; auto-resets draw from the rollouts' spawn pool
    (``rollout_spawn_pool``). ``starts`` marks each
    env stream's first frame and the frame after every auto-reset."""
    dev = resolve_device(device)
    town = town.to(dev)
    renders = {c: make_renderer(params, town, rcfg, device=dev, camera=c) for c in cameras}
    pool = rollout_spawn_pool(params, town).to(dev)
    states = reset_env(params, town, generator, n_envs)
    steps = []
    for _ in range(n_steps):
        out = {"views": {c: _quantize(r(states)["gray"]) for c, r in renders.items()}}
        expert = autopilot_control(params, town, states)
        out.update(sensor=sensor_vector(params, states),
                   traffic=traffic_light_state(params, town, states),
                   steer=expert.steer, throttle=expert.throttle, brake=expert.brake)
        fresh = pick_fresh_packed(pool, params, states)
        states, info = step_env(params, town, states, expert, fresh)
        out["done"] = info["done"]
        steps.append(out)
    traj = {k: torch.stack([o[k] for o in steps]) for k in steps[0] if k != "views"}
    frames = {c: _env_major(torch.stack([o["views"][c] for o in steps])) for c in cameras}
    state_log = _state_log(*(_env_major(traj[k]) for k in
                             ("steer", "throttle", "brake", "traffic", "sensor")))
    return frames, state_log, _episode_starts(_env_major(traj["done"]), n_envs, n_steps)


def dagger_iteration(params: SimParams, town: TownMap, rcfg: RenderConfig,
                     policy_fn: Callable, generator: torch.Generator, n_envs: int = 16,
                     n_steps: int = 256, frame_skip: int = 4,
                     noise: NoiseConfig | None = None, control_space: str = "discrete",
                     goal_ids=None, cameras: tuple = ("camera",),
                     device: str | torch.device = "cuda"):
    """One DAgger round: the policy drives, the expert labels →
    ``collect_dataset``'s (FrameStore, StateLog, traj). A continuous policy
    drives with ``control_space="continuous"``; the store's ``actions`` and
    ``controls`` stay the expert's. ``goal_ids`` makes the round
    goal-directed: the policy attempts the routes."""
    return collect_dataset(params, town, rcfg, generator, n_envs, n_steps, frame_skip,
                           policy_fn=policy_fn, noise=noise, control_space=control_space,
                           goal_ids=goal_ids, cameras=cameras, device=device)


def evaluate_policy(params: SimParams, town: TownMap, rcfg: RenderConfig,
                    policy_fn: Callable | None, generator: torch.Generator,
                    n_envs: int = 64, n_steps: int = 200, frame_skip: int = 4,
                    spawn_pool: torch.Tensor | None = None,
                    control_space: str = "discrete",
                    device: str | torch.device = "cuda",
                    shield: ShieldConfig | None = None,
                    policy_carry_init: Callable | None = None,
                    cameras: tuple = ("camera",), mesh=None) -> dict:
    """Driving metrics for a policy (or the expert when ``policy_fn`` is
    None): raw per-step rates plus the CARLA-leaderboard-style composite —
    per env stream, route completion (odometer and along-route) times the
    infraction penalty 0.60^collisions · 0.65^offroads · 0.70^red-runs.
    With a ``shield`` the rollout runs under it and the metrics gain its
    interventions per km and active share. ``policy_carry_init`` runs a
    recurrent policy, and ``cameras`` a surround rig (``make_rollout``).
    ``mesh`` shards the fleet; the metrics are the global fleet's."""
    init_fn, rollout_fn = make_rollout(params, town, rcfg, policy_fn, frame_skip,
                                       spawn_pool=spawn_pool, device=device,
                                       control_space=control_space, shield=shield,
                                       policy_carry_init=policy_carry_init,
                                       cameras=cameras, mesh=mesh)
    _, traj = rollout_fn(init_fn(generator, n_envs), n_steps)
    return driving_metrics(params, traj, mesh)


def evaluate_routes(params: SimParams, town: TownMap, rcfg: RenderConfig,
                    policy_fn: Callable | None, generator: torch.Generator,
                    n_envs: int = 64, n_steps: int = 600, frame_skip: int = 4,
                    control_space: str = "discrete", goal_ids=None,
                    spawn_pool: torch.Tensor | None = None,
                    device: str | torch.device = "cuda",
                    cameras: tuple = ("camera",), mesh=None) -> dict:
    """Goal-directed (A→B) driving metrics on a town with nav tables: each
    env drives to its goal (``goal_ids`` (B,), by default round-robin over
    ``town.nav_goals``), arrivals end the episode and the env tries again
    from a fresh spawn; ``cameras`` is the policy's rig. ``mesh`` shards
    the fleet (``goal_ids`` stay the global fleet's). → ``route_metrics``
    of the rollout."""
    if town.nav_goals is None:
        raise ValueError("evaluate_routes needs a town with nav tables "
                         "(sim.planner.plan_to_goals)")
    init_fn, rollout_fn = make_rollout(params, town, rcfg, policy_fn, frame_skip,
                                       spawn_pool=spawn_pool, device=device,
                                       control_space=control_space, cameras=cameras,
                                       mesh=mesh)
    carry = init_fn(generator, n_envs)
    n_goals = int(town.nav_goals.shape[0])
    if goal_ids is None:
        goal_ids = np.arange(n_envs) % n_goals
    if mesh is not None:
        goal_ids = np.asarray(goal_ids)[mesh.rows(n_envs)]
    _, traj = rollout_fn(assign_goals(carry, goal_ids), n_steps)
    return route_metrics(params, traj, n_goals, mesh)


def _global_sums(sums: dict, mesh) -> dict:
    """Per-rank float64 sums and counts → their totals over the mesh's
    ``data`` axis, in one all-reduce (unchanged without a mesh)."""
    if mesh is None:
        return sums
    keys = list(sums)
    flat = torch.tensor([float(sums[k]) for k in keys], dtype=torch.float64,
                        device=mesh.device)
    mesh.all_reduce_(flat)
    return dict(zip(keys, flat.cpu().numpy().tolist()))


def route_metrics(params: SimParams, traj: dict, n_goals: int, mesh=None) -> dict:
    """The A→B metrics of a goal-directed rollout's (T, B) trajectory, from
    a host walk over each env's episodes: an episode ends in an arrival, a
    crash (collision or off-road), a timeout, or — length 1 with neither —
    an unreachable spawn's respawn, which is not an attempt (the spawn
    failed, not the driving). The unfinished last episode of each env is not
    counted. Infractions count crash episodes, not flagged steps. Under a
    ``mesh`` the counts are summed over the global fleet."""
    done = traj["done"].cpu().numpy().astype(bool)               # (T, B)
    arrived = traj["arrived"].cpu().numpy().astype(bool)
    crashed = (traj["collision"] | traj["offroad"]).cpu().numpy().astype(bool)
    arrivals = crashes = timeouts = steps_to_arrival = 0
    for b in range(done.shape[1]):
        start = 0
        for t in np.nonzero(done[:, b])[0]:
            length = int(t) - start + 1
            start = int(t) + 1
            if arrived[t, b]:
                arrivals += 1
                steps_to_arrival += length
            elif crashed[t, b]:
                crashes += 1
            elif length > 1:
                timeouts += 1
    tot = _global_sums({
        "arrivals": arrivals, "crashes": crashes, "timeouts": timeouts,
        "steps_to_arrival": steps_to_arrival, "env_steps": done.size,
        "speed": traj["speed"].cpu().numpy().astype(np.float64).sum()}, mesh)
    arrivals, crashes, timeouts = (int(tot[k]) for k in ("arrivals", "crashes", "timeouts"))
    km = float(tot["speed"] * params.dt / 1000.0)
    attempts = arrivals + crashes + timeouts
    mean_steps = tot["steps_to_arrival"] / arrivals if arrivals else None
    return {
        "goals": n_goals,
        "attempts": attempts,
        "arrivals": arrivals,
        "arrival_rate": arrivals / attempts if attempts else 0.0,
        "crashes": crashes,
        "timeouts": timeouts,
        "mean_steps_to_arrival": mean_steps,
        "mean_seconds_to_arrival": None if mean_steps is None else mean_steps * params.dt,
        "km_driven": km,
        "arrivals_per_km": arrivals / km if km > 0 else None,
        "infractions_per_km": crashes / km if km > 0 else None,
        "env_steps": int(tot["env_steps"]),
    }


def driving_metrics(params: SimParams, traj: dict, mesh=None) -> dict:
    """The metrics of ``evaluate_policy`` from a rollout's (T, B) trajectory;
    under a ``mesh`` (B the rank's rows) from sums and counts over the
    global fleet, never means of per-rank means."""
    traj = {k: v.cpu().numpy() for k, v in traj.items()}
    n_steps, n_envs = traj["speed"].shape
    speed = traj["speed"].astype(np.float64)              # (T, B)
    coll = traj["collision"].astype(bool)
    off = traj["offroad"].astype(bool)
    red = traj["red_light"].astype(bool)
    done = traj["done"].astype(bool)
    ran_red = traj["ran_red"].astype(bool)
    km_env = speed.sum(axis=0) * params.dt / 1000.0
    ideal_km = n_steps * params.dt * params.target_speed / 1000.0
    completion = np.clip(km_env / ideal_km, 0.0, 1.0)
    route_km_env = np.clip(traj["route_ds"].astype(np.float64).sum(axis=0),
                           0.0, None) / 1000.0
    arc_completion = np.clip(route_km_env / ideal_km, 0.0, 1.0)
    penalty = (0.60 ** coll.sum(0)) * (0.65 ** off.sum(0)) * (0.70 ** ran_red.sum(0))
    steer_cmd = traj["steer"].astype(np.float64)
    dsteer = np.abs(np.diff(steer_cmd, axis=0))
    valid = ~done[:-1]
    sums = {
        "envs": n_envs, "speed": speed.sum(), "dsteer": (dsteer * valid).sum(),
        "valid": valid.sum(), "coll": coll.sum(), "off": off.sum(), "done": done.sum(),
        "red": red.sum(), "ran_red": ran_red.sum(),
        "agree": (traj["action"] == traj["expert_action"]).sum(), "km": km_env.sum(),
        "clean": (~(coll.any(0) | off.any(0))).sum(), "completion": completion.sum(),
        "score": (completion * penalty).sum(), "route_km": route_km_env.sum(),
        "arc": arc_completion.sum(), "score_arc": (arc_completion * penalty).sum(),
    }
    if "shield" in traj:
        sums["shield"] = traj["shield"].astype(bool).sum()
    tot = _global_sums(sums, mesh)
    n_envs = int(tot["envs"])
    steps = n_envs * n_steps
    km = float(tot["km"])

    def per_km(count: float) -> float | None:
        if km > 0:
            return count / km
        return None if count else 0.0

    out = {
        "mean_speed": float(tot["speed"] / steps),
        "steer_rate": float(tot["dsteer"] / max(tot["valid"], 1)),
        "collisions_per_1k_steps": float(tot["coll"]) / steps * 1000,
        "offroad_per_1k_steps": float(tot["off"]) / steps * 1000,
        "episodes_ended": int(tot["done"]),
        "red_light_exposure": float(tot["red"] / steps),
        "action_agreement": float(tot["agree"] / steps),
        "env_steps": steps,
        "km_driven": km,
        "collisions_per_km": per_km(float(tot["coll"])),
        "offroad_per_km": per_km(float(tot["off"])),
        "red_violations_per_km": per_km(float(tot["ran_red"])),
        "clean_episode_rate": float(tot["clean"] / n_envs),
        "mean_episode_steps": steps / (int(tot["done"]) + n_envs),
        "route_completion": float(tot["completion"] / n_envs),
        "driving_score": float(tot["score"] / n_envs),
        "route_km": float(tot["route_km"]),
        "route_completion_arc": float(tot["arc"] / n_envs),
        "driving_score_arc": float(tot["score_arc"] / n_envs),
    }
    if "shield" in tot:
        out["shield_interventions_per_km"] = per_km(float(tot["shield"]))
        out["shield_active_frac"] = float(tot["shield"]) / steps
    return out

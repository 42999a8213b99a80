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
``collect_dataset`` packs a rollout into a ``FrameStore`` for training;
with a ``NoiseConfig`` it perturbs the executed steering with triangular
impulses while the labels stay the clean driver's, and with a policy it is
the DAgger aggregation step (``dagger_iteration``).
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
from carla_imitation_learning_tpu_torch.render.pipeline import (
    RenderConfig, make_renderer, make_scene_setup,
)
from carla_imitation_learning_tpu_torch.sim.town import TownMap
from carla_imitation_learning_tpu_torch.sim.world import (
    SimParams, VehicleControl, autopilot_control, make_spawn_pool,
    navigation_command, pick_fresh_packed, reset_env, sensor_vector, step_env,
    traffic_light_state,
)

SPAWN_POOL_SEED = 0x5EED
SPAWN_POOL_SIZE = 1024


def update_framebuf(framebuf: torch.Tensor, gray: torch.Tensor,
                    just_reset: torch.Tensor) -> torch.Tensor:
    """Slide the per-env frame window (B, H, W, fs); envs that auto-reset on
    the previous step get their window refilled with the fresh view, so an
    observation never blends two episodes. gray (B, H, W), just_reset (B,)."""
    gray = gray[..., None]
    frame_skip = framebuf.shape[-1]
    return torch.where(just_reset[:, None, None, None],
                       gray.expand(-1, -1, -1, frame_skip),
                       torch.cat([framebuf[..., 1:], gray], -1))


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


def noise_generator(ncfg: NoiseConfig, states) -> torch.Generator:
    """A CPU generator seeded from ``ncfg.seed`` and the sum of the fleet's
    per-env keys (one host read), so collections from different fleet
    states draw different schedules and a repeat draws the same one. Both
    are hashed into the 32 bits the CPU generator's seed keeps."""
    key_sum = int(states.rng.sum())
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
                 policy_rng: torch.Generator | None = None):
    """Build (init_fn, rollout_fn) for a single-camera fleet.

    ``policy_fn(obs)`` maps the NHWC float window (B, H, W, frame_skip) in
    [0, 1] to (B,) integer actions, or to ``(actions, extra)`` with a (B,)
    per-env scalar (an ensemble's disagreement) logged as
    ``traj["policy_extra"]``; None drives with the autopilot expert. A
    policy of two parameters is called ``policy_fn(obs, extras)`` with
    ``extras = {"speed": (B,), "command": (B,) navigation command, "sensor":
    (B, 3)}`` of the state before the step (and ``"rng"``, the
    ``policy_rng`` generator, when one is given); one of three parameters
    also gets ``rollout_fn``'s ``policy_params``.
    ``control_space="continuous"`` takes the policy's output as (B, 2)
    float controls, clipped to [-1, 1]: steer, and a signed acceleration
    executed as throttle max(a, 0) and brake max(−a, 0);
    ``traj["action"]`` then holds ``control_to_discrete_label`` of the
    executed control.
    ``noise`` adds a ``NoiseConfig`` schedule, drawn once per
    ``rollout_fn`` call, to the executed steer (clipped to [-1, 1]);
    ``traj["clean_steer"]`` then holds the steer before the noise, and the
    labels and ``traj["action"]`` stay clean.
    ``spawn_pool`` is a packed (size, D) pool (``sim.world.pack_spawn_pool``
    layout, so the JAX package's pool can be passed in); None builds the
    default one. The renderer is forced onto the fast grayscale kernel with
    a 2-pixel LOD unless ``rcfg.lod_px`` says otherwise. ``record_semantic``
    adds ``traj["semantic"]`` (T, B, H, W) uint8: the class ids of the
    driving view, from a second scene setup of the same state rendered on
    the exact luma path (``replace(rcfg, fast=False, rgb=False)``).

    ``init_fn(generator, n_envs) -> carry`` with carry = (states, framebuf
    (B, H, W, fs) uint8, just_reset (B,) bool); ``rollout_fn(carry, n_steps,
    policy_params=None) -> (carry, traj)`` where traj stacks per-step (T, B,
    ...) tensors."""
    if control_space not in ("discrete", "continuous"):
        raise ValueError(f"unknown control_space {control_space!r}")
    continuous = control_space == "continuous"
    n_policy_args = 0 if policy_fn is None else len(inspect.signature(policy_fn).parameters)
    dev = resolve_device(device)
    town = town.to(dev)
    rcfg = dataclasses.replace(rcfg, rgb=False, fast=True)
    if rcfg.lod_px < 0.0:
        rcfg = dataclasses.replace(rcfg, lod_px=2.0)
    render = make_renderer(params, town, rcfg, device=dev)
    sem_setup = None
    if record_semantic:
        sem_rcfg = dataclasses.replace(rcfg, fast=False, rgb=False)
        sem_setup = make_scene_setup(params, town, sem_rcfg, device=dev)
    pool = (rollout_spawn_pool(params, town) if spawn_pool is None
            else spawn_pool).to(dev)

    @torch.no_grad()
    def init_fn(generator: torch.Generator, n_envs: int):
        states = reset_env(params, town, generator, n_envs)
        framebuf = _quantize(render(states)["gray"])[..., None].repeat(1, 1, 1, frame_skip)
        return states, framebuf, torch.zeros(n_envs, dtype=torch.bool, device=dev)

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
        states, framebuf, just_reset = carry
        gray_u8 = _quantize(render(states)["gray"])
        framebuf = update_framebuf(framebuf, gray_u8, just_reset)
        obs = framebuf.to(torch.float32) * (1.0 / 255.0)

        sensors = sensor_vector(params, states)
        traffic = traffic_light_state(params, town, states)
        command = navigation_command(params, town, states)
        expert = autopilot_control(params, town, states)
        expert_action = continuous_to_discrete(
            expert.steer, expert.throttle, expert.brake).to(torch.int64)
        policy_extra = None
        if policy_fn is None:
            control, action = expert, expert_action
        else:
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
        clean_steer = None
        if steer_noise is not None:
            clean_steer = control.steer
            control = dataclasses.replace(
                control, steer=torch.clamp(control.steer + steer_noise, -1.0, 1.0))

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
        if sem_setup is not None:
            _, sem, _ = rasterize_exact_luma(sem_setup(states), rcfg.height, rcfg.width,
                                             near=rcfg.near, far=rcfg.far)
            out["semantic"] = sem.to(torch.uint8)
        if policy_extra is not None:
            out["policy_extra"] = policy_extra
        if clean_steer is not None:
            out["clean_steer"] = clean_steer
        return (new_states, framebuf, info["done"]), out

    @torch.no_grad()
    def rollout_fn(carry, n_steps: int, policy_params=None):
        schedule = None
        if noise is not None:
            n_envs = carry[0].t.shape[0]
            schedule = _noise_schedule(noise_generator(noise, carry[0]), n_steps, n_envs,
                                       noise).to(dev)
        outs = []
        for t in range(n_steps):
            carry, out = one_step(carry, None if schedule is None else schedule[t],
                                  policy_params)
            outs.append(out)
        return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return init_fn, rollout_fn


def assign_goals(carry, goal_ids):
    """Give each env of a rollout carry a navigation goal: ``goal_ids`` (B,)
    indexes ``town.nav_goals`` (``sim.planner.plan_to_goals``); −1 keeps
    that env free-roaming, exactly as without goals."""
    states = carry[0]
    goal = torch.as_tensor(np.asarray(goal_ids), dtype=torch.int64).to(states.goal.device)
    return (states.replace(goal=goal),) + tuple(carry[1:])


def semantic_stream(traj: dict) -> np.ndarray:
    """Env-major (B·T, H, W) uint8 class ids of the driving view from a
    ``record_semantic`` rollout, frame-aligned with the env-major frame
    stream a collection writes."""
    sem = traj["semantic"]                                  # (T, B, H, W)
    return sem.transpose(0, 1).reshape((-1,) + tuple(sem.shape[2:])).cpu().numpy()


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
    lets a continuous policy drive (labels stay the expert's). The
    trajectory stays on the device until one host copy per field."""
    if tuple(cameras) != ("camera",):
        raise NotImplementedError(
            "multi-camera collection is not ported yet (ROADMAP Queue 1 item 10)")
    init_fn, rollout_fn = make_rollout(params, town, rcfg, policy_fn, frame_skip,
                                       device=device, record_semantic=record_semantic,
                                       noise=noise, control_space=control_space)
    carry = init_fn(generator, n_envs)
    if goal_ids is not None:
        carry = assign_goals(carry, goal_ids)
    _, traj = rollout_fn(carry, n_steps)

    def flat(x: torch.Tensor) -> np.ndarray:
        """(T, B, ...) → env-major (B·T, ...) on the host."""
        return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:])).cpu().numpy()

    sensor = flat(traj["sensor"])
    steer = flat(traj.get("clean_steer", traj["steer"]))
    traffic = flat(traj["traffic"])
    state = StateLog(
        steer=steer.astype(np.float64),
        throttle=flat(traj["throttle"]).astype(np.float64),
        brake=flat(traj["brake"]).astype(np.float64),
        trafficlight=traffic.astype(np.float64),
        current_steer=sensor[:, 0].astype(np.float64),
        speed_long=sensor[:, 1].astype(np.float64),
        speed=sensor[:, 2].astype(np.float64),
    )
    done_flat = flat(traj["done"]).astype(bool)
    starts = np.zeros(n_envs * n_steps, bool)
    starts[::n_steps] = True
    starts[1:] |= done_flat[:-1]
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
                    device: str | torch.device = "cuda") -> dict:
    """Driving metrics for a policy (or the expert when ``policy_fn`` is
    None): raw per-step rates plus the CARLA-leaderboard-style composite —
    per env stream, route completion (odometer and along-route) times the
    infraction penalty 0.60^collisions · 0.65^offroads · 0.70^red-runs."""
    init_fn, rollout_fn = make_rollout(params, town, rcfg, policy_fn, frame_skip,
                                       spawn_pool=spawn_pool, device=device,
                                       control_space=control_space)
    _, traj = rollout_fn(init_fn(generator, n_envs), n_steps)
    return driving_metrics(params, traj)


def evaluate_routes(params: SimParams, town: TownMap, rcfg: RenderConfig,
                    policy_fn: Callable | None, generator: torch.Generator,
                    n_envs: int = 64, n_steps: int = 600, frame_skip: int = 4,
                    control_space: str = "discrete", goal_ids=None,
                    spawn_pool: torch.Tensor | None = None,
                    device: str | torch.device = "cuda") -> dict:
    """Goal-directed (A→B) driving metrics on a town with nav tables: each
    env drives to its goal (``goal_ids`` (B,), by default round-robin over
    ``town.nav_goals``), arrivals end the episode and the env tries again
    from a fresh spawn. → ``route_metrics`` of the rollout."""
    if town.nav_goals is None:
        raise ValueError("evaluate_routes needs a town with nav tables "
                         "(sim.planner.plan_to_goals)")
    init_fn, rollout_fn = make_rollout(params, town, rcfg, policy_fn, frame_skip,
                                       spawn_pool=spawn_pool, device=device,
                                       control_space=control_space)
    carry = init_fn(generator, n_envs)
    n_goals = int(town.nav_goals.shape[0])
    if goal_ids is None:
        goal_ids = np.arange(n_envs) % n_goals
    _, traj = rollout_fn(assign_goals(carry, goal_ids), n_steps)
    return route_metrics(params, traj, n_goals)


def route_metrics(params: SimParams, traj: dict, n_goals: int) -> dict:
    """The A→B metrics of a goal-directed rollout's (T, B) trajectory, from
    a host walk over each env's episodes: an episode ends in an arrival, a
    crash (collision or off-road), a timeout, or — length 1 with neither —
    an unreachable spawn's respawn, which is not an attempt (the spawn
    failed, not the driving). The unfinished last episode of each env is not
    counted. Infractions count crash episodes, not flagged steps."""
    done = traj["done"].cpu().numpy().astype(bool)               # (T, B)
    arrived = traj["arrived"].cpu().numpy().astype(bool)
    crashed = (traj["collision"] | traj["offroad"]).cpu().numpy().astype(bool)
    km = float(traj["speed"].cpu().numpy().astype(np.float64).sum() * params.dt / 1000.0)
    arrivals = crashes = timeouts = 0
    steps_to_arrival = []
    for b in range(done.shape[1]):
        start = 0
        for t in np.nonzero(done[:, b])[0]:
            length = int(t) - start + 1
            start = int(t) + 1
            if arrived[t, b]:
                arrivals += 1
                steps_to_arrival.append(length)
            elif crashed[t, b]:
                crashes += 1
            elif length > 1:
                timeouts += 1
    attempts = arrivals + crashes + timeouts
    mean_steps = float(np.mean(steps_to_arrival)) if steps_to_arrival else None
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
        "env_steps": int(done.size),
    }


def driving_metrics(params: SimParams, traj: dict) -> dict:
    """The metrics of ``evaluate_policy`` from a rollout's (T, B) trajectory."""
    traj = {k: v.cpu().numpy() for k, v in traj.items()}
    n_steps, n_envs = traj["speed"].shape
    steps = n_envs * n_steps
    speed = traj["speed"].astype(np.float64)              # (T, B)
    coll = traj["collision"].astype(bool)
    off = traj["offroad"].astype(bool)
    red = traj["red_light"].astype(bool)
    done = traj["done"].astype(bool)
    ran_red = traj["ran_red"].astype(bool)
    km_env = speed.sum(axis=0) * params.dt / 1000.0
    km = float(km_env.sum())

    def per_km(count: float) -> float | None:
        if km > 0:
            return count / km
        return None if count else 0.0

    ideal_km = n_steps * params.dt * params.target_speed / 1000.0
    completion = np.clip(km_env / ideal_km, 0.0, 1.0)
    route_km_env = np.clip(traj["route_ds"].astype(np.float64).sum(axis=0),
                           0.0, None) / 1000.0
    arc_completion = np.clip(route_km_env / ideal_km, 0.0, 1.0)
    penalty = (0.60 ** coll.sum(0)) * (0.65 ** off.sum(0)) * (0.70 ** ran_red.sum(0))
    steer_cmd = traj["steer"].astype(np.float64)
    dsteer = np.abs(np.diff(steer_cmd, axis=0))
    valid = ~done[:-1]
    return {
        "mean_speed": float(speed.mean()),
        "steer_rate": float((dsteer * valid).sum() / max(valid.sum(), 1)),
        "collisions_per_1k_steps": float(coll.sum()) / steps * 1000,
        "offroad_per_1k_steps": float(off.sum()) / steps * 1000,
        "episodes_ended": int(done.sum()),
        "red_light_exposure": float(red.mean()),
        "action_agreement": float((traj["action"] == traj["expert_action"]).mean()),
        "env_steps": steps,
        "km_driven": km,
        "collisions_per_km": per_km(float(coll.sum())),
        "offroad_per_km": per_km(float(off.sum())),
        "red_violations_per_km": per_km(float(ran_red.sum())),
        "clean_episode_rate": float((~(coll.any(0) | off.any(0))).mean()),
        "mean_episode_steps": steps / (int(done.sum()) + n_envs),
        "route_completion": float(completion.mean()),
        "driving_score": float((completion * penalty).mean()),
        "route_km": float(route_km_env.sum()),
        "route_completion_arc": float(arc_completion.mean()),
        "driving_score_arc": float((arc_completion * penalty).mean()),
    }

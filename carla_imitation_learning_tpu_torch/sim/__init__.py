"""Batched driving simulator: every function steps a whole fleet (leading
env axis ``B``) with plain tensor ops."""

from carla_imitation_learning_tpu_torch.sim.town import TownMap, make_town, route_point  # noqa: F401
from carla_imitation_learning_tpu_torch.sim.world import (  # noqa: F401
    SimParams, VehicleControl, WorldState, autopilot_control,
    make_spawn_pool, navigation_command, pack_spawn_pool, pick_fresh_packed,
    reset_env, sensor_vector, step_env, traffic_light_state,
)

"""The closed loop's fleet step in plain PyTorch, from the frozen simulator
copy: the scene assembly and projection of each env's camera, the plain
z-buffer frame quantised to uint8, the 4-frame window (refilled with the
fresh view after an auto-reset), and the sim step with auto-resets drawn
from the packed spawn pool (seed 0x5EED, 1024 states), driven by the
actions it is given.

``precision="low"`` is the control's: the state's float fields rounded to
bfloat16 after every step and the frame's edge and depth arithmetic in
bfloat16."""

from __future__ import annotations

import dataclasses

import torch

from perfbench.reference.actions import discrete_to_continuous
from perfbench.reference.raster import rasterize_gray
from perfbench.reference.render import geometry as geo
from perfbench.reference.render.camera import camera_from_ego, project_triangles
from perfbench.reference.sim import agents as agent_lib
from perfbench.reference.sim import world
from perfbench.reference.sim.town import make_town

SPAWN_POOL_SEED, SPAWN_POOL_SIZE = 0x5EED, 1024


class RefLoop:
    def __init__(self, sim: dict, town: dict, render: dict, device, precision: str = "fp32"):
        self.dev = torch.device(device)
        self.params = world.SimParams(**sim)
        self.town = make_town(**town).to(self.dev)
        self.render = dict(render)
        self.static = geo.build_static_scene(self.town).to(self.dev)
        gen = torch.Generator().manual_seed(SPAWN_POOL_SEED)
        self.pool = world.make_spawn_pool(self.params, self.town, gen, SPAWN_POOL_SIZE)
        self.low = precision == "low"

    def reset(self, generator: torch.Generator, n_envs: int) -> world.WorldState:
        return world.reset_env(self.params, self.town, generator, n_envs)

    def frame(self, st: world.WorldState):
        """→ (uint8 (B, H, W) frame, (B,) covering pairs, (B,) triangles kept)."""
        r, p, town = self.render, self.params, self.town
        phases = agent_lib.light_phases(town, st.t.to(torch.float32) * p.dt,
                                        p.light_green, p.light_yellow, p.light_red)
        ap, ay = agent_lib.agent_positions(town, st.agents_route, st.agents_s)
        tris, colors, classes = geo.assemble_scene(self.static, town.lights_pos, phases, ap, ay,
                                                   r["max_triangles"])
        cam = camera_from_ego(st.ego_pos, st.ego_yaw)
        cullable = ((classes == geo.SEM_BUILDING) | (classes == geo.SEM_VEHICLE)
                    | (classes == geo.SEM_PEDESTRIAN))
        s = project_triangles(tris, colors, classes, cam, r["width"], r["height"],
                              r.get("fov_deg", 90.0), r.get("near", 0.5), cullable=cullable)
        far, lod = r.get("far", 300.0), r.get("lod_px", 0.0)
        gray, covering = rasterize_gray(
            s.edges, s.znum, s.colors, s.valid, s.bbox, s.zmin, r["height"], r["width"],
            near=r.get("near", 0.5), far=far, lod_px=lod,
            dtype=torch.bfloat16 if self.low else torch.float32)
        kept = s.valid & (s.zmin < far)
        if lod > 0:
            kept = kept & ((s.bbox[..., 1] - s.bbox[..., 0] >= lod)
                           | (s.bbox[..., 3] - s.bbox[..., 2] >= lod))
        u8 = torch.clamp(gray * 255.0 + 0.5, 0, 255).to(torch.uint8)
        return u8, covering, kept.sum(-1)

    def step(self, st: world.WorldState, action: torch.Tensor):
        steer, throttle, brake = discrete_to_continuous(action)
        control = world.VehicleControl(steer=steer, throttle=throttle, brake=brake)
        fresh = world.pick_fresh_packed(self.pool, self.params, st)
        new, info = world.step_env(self.params, self.town, st, control, fresh)
        if self.low:
            new = dataclasses.replace(new, **{
                f.name: getattr(new, f.name).to(torch.bfloat16).to(torch.float32)
                for f in dataclasses.fields(new)
                if getattr(new, f.name).dtype == torch.float32})
        return new, info


def update_window(window: torch.Tensor, frame: torch.Tensor, just_reset: torch.Tensor):
    """(B, H, W, fs) uint8 window → the oldest frame dropped and ``frame``
    appended, or every slot set to ``frame`` where ``just_reset``."""
    rolled = torch.cat([window[..., 1:], frame[..., None]], -1)
    fresh = frame[..., None].expand_as(window)
    return torch.where(just_reset[:, None, None, None], fresh, rolled)

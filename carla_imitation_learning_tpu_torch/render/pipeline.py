"""Render pipeline: fleet world state → camera frames.

``make_renderer`` closes over the static scene and returns ``render(state)``
for a whole fleet. Three branches, as in the JAX package: the fast
grayscale rollout kernel (``fast=True, rgb=False``: kernel B, or C with
``quads``, or D with ``vec``), the exact kernel's grayscale path
(``rgb=False``) and its RGB path (``rgb=True``); with ``texture_detail`` the
exact branches take kernel A's textured variant. On a CUDA device the
kernels run; on the CPU their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses

import torch

from carla_imitation_learning_tpu_torch.device import resolve_device
from carla_imitation_learning_tpu_torch.ops.raster import (
    luma, rasterize_exact, rasterize_exact_luma,
)
from carla_imitation_learning_tpu_torch.ops.raster_fast import rasterize_luma_fast
from carla_imitation_learning_tpu_torch.render import geometry as geo
from carla_imitation_learning_tpu_torch.render.camera import camera_from_ego, project_triangles
from carla_imitation_learning_tpu_torch.render.plain_raster import semantic_to_rgb, sky_image
from carla_imitation_learning_tpu_torch.render.weather import apply_fog
from carla_imitation_learning_tpu_torch.sim import agents as agent_lib
from carla_imitation_learning_tpu_torch.sim.pedestrians import ped_positions
from carla_imitation_learning_tpu_torch.sim.town import TownMap
from carla_imitation_learning_tpu_torch.sim.world import SimParams, WorldState


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    height: int = 128
    width: int = 128
    fov_deg: float = 90.0
    max_triangles: int = 512
    near: float = 0.5
    far: float = 300.0
    rgb: bool = True       # False → grayscale-only paths
    fast: bool = False     # grayscale-only rollout kernel (kernel B)
    active_cap: int | None = None  # fast path: pre-compact valid triangles
    fog_density: float = 0.0  # exponential fog β (1/m); 0 = clear weather
    lod_px: float = -1.0   # fast path: cull triangles under this many pixels
                           # both ways; −1 = auto (2 px inside rollouts)
    facade_bands: int = 0  # >0: window-floor stripes on building walls
    shadows: bool = False  # blob contact shadows under vehicles and walkers
    markings: bool = False  # lane markings and zebra crosswalks (SEM_ROADLINE)
    texture_detail: bool = False  # procedural textures; exact branches only
    quads: bool = False    # fast path: fused quad primitives (kernel C)
    vec: bool = False      # fast path: grouped band tables (kernel D);
                           # ignored when quads=True
    # Not ported yet (ROADMAP Queue 1); setting either raises.
    sun: float = 1.0
    rain: float = 0.0

    @classmethod
    def from_cfg(cls, cfg) -> "RenderConfig":
        """The ``render`` block of a composed config."""
        r = cfg.render
        return cls(height=int(r.height), width=int(r.width),
                   fov_deg=float(r.fov_deg), max_triangles=int(r.max_triangles),
                   near=float(r.near), far=float(r.far),
                   rgb=bool(r.get("rgb", True)), fast=bool(r.get("fast", False)),
                   active_cap=int(r["active_cap"]) if r.get("active_cap") else None,
                   fog_density=float(r.get("fog_density", 0.0)),
                   lod_px=float(r.get("lod_px", -1.0)),
                   facade_bands=int(r.get("facade_bands", 0)),
                   shadows=bool(r.get("shadows", False)),
                   markings=bool(r.get("markings", False)),
                   texture_detail=bool(r.get("texture_detail", False)),
                   quads=bool(r.get("quads", False)), vec=bool(r.get("vec", False)),
                   sun=float(r.get("sun", 1.0)), rain=float(r.get("rain", 0.0)))

    @property
    def fast_path(self) -> bool:
        return self.fast and not self.rgb

    def check_ported(self) -> None:
        off = {"sun": self.sun < 1.0, "rain": self.rain > 0.0}
        unported = [k for k, on in off.items() if on]
        if unported:
            raise NotImplementedError(f"render options not ported yet: {unported}")


def make_scene_setup(params: SimParams, town: TownMap, rcfg: RenderConfig,
                     device: str | torch.device = "cuda"):
    """→ scene_setup(state) → TriangleSetup of a fleet state seen from the
    forward camera: the scene assembly and projection every render branch
    starts from. The setup carries the surface-UV rows when the exact
    branches texture, and the quad rows when the fast branch fuses quads."""
    dev = resolve_device(device)
    town = town.to(dev)
    static = geo.build_static_scene(town, facade_bands=rcfg.facade_bands,
                                    markings=rcfg.markings).to(dev)
    textures = rcfg.texture_detail and not rcfg.fast_path
    quads = rcfg.quads and rcfg.fast_path

    def scene_setup(state: WorldState):
        phases = agent_lib.light_phases(
            town, state.t.to(torch.float32) * params.dt,
            params.light_green, params.light_yellow, params.light_red)
        agents_pos, agents_yaw = agent_lib.agent_positions(
            town, state.agents_route, state.agents_s)
        peds_pos = None
        if state.peds_s.shape[1] > 0:
            peds_pos = ped_positions(town, state.peds_crossing, state.peds_s)
        tris, colors, classes = geo.assemble_scene(
            static, town.lights_pos, phases, agents_pos, agents_yaw,
            rcfg.max_triangles, peds_pos=peds_pos, shadows=rcfg.shadows)
        cam = camera_from_ego(state.ego_pos, state.ego_yaw)
        # closed boxes with outward-wound faces are backface-cullable;
        # ground, roads, poles and light heads stay double-sided
        cullable = ((classes == geo.SEM_BUILDING) | (classes == geo.SEM_VEHICLE)
                    | (classes == geo.SEM_PEDESTRIAN))
        return project_triangles(tris, colors, classes, cam, rcfg.width,
                                 rcfg.height, rcfg.fov_deg, rcfg.near,
                                 cullable=cullable, textures=textures, quads=quads)

    return scene_setup


def make_renderer(params: SimParams, town: TownMap, rcfg: RenderConfig,
                  device: str | torch.device = "cuda"):
    """→ render(state) for a fleet state on ``device``: the fast branch
    returns {'gray'}; the exact branches add 'semantic', 'depth',
    'semantic_rgb' (and 'rgb' for ``rgb=True``)."""
    rcfg.check_ported()
    dev = resolve_device(device)
    scene_setup = make_scene_setup(params, town, rcfg, dev)

    def render(state: WorldState) -> dict:
        setup = scene_setup(state)
        if rcfg.fast_path:  # rollout kernel: gray plane only
            gray = rasterize_luma_fast(
                setup, rcfg.height, rcfg.width, near=rcfg.near, far=rcfg.far,
                compact_cap=rcfg.active_cap, fog_density=rcfg.fog_density,
                lod_px=max(rcfg.lod_px, 0.0), quads=rcfg.quads, vec=rcfg.vec)
            return {"gray": gray}
        if not rcfg.rgb:
            gray, sem, depth = rasterize_exact_luma(
                setup, rcfg.height, rcfg.width, near=rcfg.near, far=rcfg.far)
            sky_l = luma(sky_image(rcfg.height, rcfg.width, dev))
            gray = apply_fog(gray, depth, sky_l, rcfg.fog_density)
            return {"semantic": sem, "gray": gray, "depth": depth,
                    "semantic_rgb": semantic_to_rgb(sem)}
        rgb, sem, depth = rasterize_exact(setup, rcfg.height, rcfg.width,
                                          near=rcfg.near, far=rcfg.far)
        rgb = apply_fog(rgb, depth, sky_image(rcfg.height, rcfg.width, dev),
                        rcfg.fog_density)
        return {"rgb": rgb, "semantic": sem, "gray": luma(rgb), "depth": depth,
                "semantic_rgb": semantic_to_rgb(sem)}

    return render

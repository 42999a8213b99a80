"""LIDAR: planar range scans by exact 2-D ray casting (the JAX package's
``render/lidar.py``), batched over the fleet.

The world is 2.5-D (buildings and vehicles are vertical boxes), so a
horizontal scan at sensor height is exact ray-segment intersection in the
plane: one (B, beams, segments) solve, with no sampling of a depth buffer.
Beam 0 points along the ego's heading and angles increase
counter-clockwise; ranges are clipped to ``max_range`` (a beam that hits
nothing returns exactly ``max_range``).
"""

from __future__ import annotations

import math

import torch

from carla_imitation_learning_tpu_torch.sim.agents import agent_positions
from carla_imitation_learning_tpu_torch.sim.pedestrians import ped_positions
from carla_imitation_learning_tpu_torch.sim.town import TownMap


def _rect_segments(corners: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) corner loops → (..., 4, 2, 2) edge segments."""
    return torch.stack([corners, torch.roll(corners, -1, dims=-2)], dim=-2)


def building_segments(buildings: torch.Tensor) -> torch.Tensor:
    """(N, 5) axis-aligned boxes (cx, cy, hw, hh, h) → (N·4, 2, 2) wall
    segments at ground level."""
    cx, cy, hw, hh = buildings[:, 0], buildings[:, 1], buildings[:, 2], buildings[:, 3]
    corners = torch.stack([
        torch.stack([cx - hw, cy - hh], -1), torch.stack([cx + hw, cy - hh], -1),
        torch.stack([cx + hw, cy + hh], -1), torch.stack([cx - hw, cy + hh], -1),
    ], dim=-2)
    return _rect_segments(corners).reshape(-1, 2, 2)


def vehicle_segments(pos: torch.Tensor, yaw: torch.Tensor, half_len: float = 2.25,
                     half_wid: float = 1.0) -> torch.Tensor:
    """(..., A, 2) centres + (..., A) yaws → (..., A·4, 2, 2) outline
    segments of rotated boxes (the 4.5 × 2.0 m render box by default)."""
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    lx = torch.tensor([half_len, -half_len, -half_len, half_len], device=pos.device)
    ly = torch.tensor([half_wid, half_wid, -half_wid, -half_wid], device=pos.device)
    corners = torch.stack([c * lx - s * ly, s * lx + c * ly], dim=-1) + pos[..., None, :]
    return _rect_segments(corners).reshape(pos.shape[:-2] + (-1, 2, 2))


def cast_rays(origin: torch.Tensor, angles: torch.Tensor, segments: torch.Tensor,
              max_range: float) -> torch.Tensor:
    """Exact first-hit distances: (..., 2) origins, (..., N) world angles and
    (..., S, 2, 2) segments → (..., N) ranges in (0, max_range].

    Solves o + t·d = p + u·(q − p) per (beam, segment) with 2-D cross
    products, keeps t where t > 1e-6 and u ∈ [0, 1] (and the ray is not
    parallel to the segment), and takes the minimum over segments."""
    dx, dy = torch.cos(angles)[..., :, None], torch.sin(angles)[..., :, None]   # (..., N, 1)
    p = segments[..., 0, :]
    e = segments[..., 1, :] - p                                 # (..., S, 2)
    r = p - origin[..., None, :]
    ex, ey = e[..., None, :, 0], e[..., None, :, 1]             # (..., 1, S)
    rx, ry = r[..., None, :, 0], r[..., None, :, 1]
    denom = dx * ey - dy * ex                                   # (..., N, S)
    parallel = denom.abs() < 1e-9
    safe = torch.where(parallel, 1.0, denom)
    t = (rx * ey - ry * ex) / safe
    u = (rx * dy - ry * dx) / safe
    ok = ~parallel & (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    t = torch.where(ok, t, math.inf)
    return torch.clamp(t.amin(dim=-1), max=max_range)


def beam_angles(n_beams: int, fov_deg: float = 360.0) -> torch.Tensor:
    """(n_beams,) float32 body-frame beam angles: the full circle ``i / n ·
    2π``, or for ``fov_deg < 360`` a sector from −fov/2 to +fov/2, both
    ends included. The sector is the JAX package's ``jnp.linspace`` as XLA
    compiles it on the CPU: the step is ``i · (1/(n−1))``, the stop term is
    reassociated to ``i · (stop · (1/(n−1)))`` and fused into one
    multiply-add with the start term (float32 throughout, the fused
    product and sum rounded once)."""
    if fov_deg >= 360.0:
        return torch.arange(n_beams, dtype=torch.float32) / n_beams * 2.0 * math.pi
    half = torch.tensor(math.radians(fov_deg), dtype=torch.float32) / 2.0
    if n_beams == 1:
        return -half[None]
    inv = torch.tensor(1.0, dtype=torch.float32) / float(n_beams - 1)
    i = torch.arange(n_beams - 1, dtype=torch.float32)
    start = -half * (1.0 - i * inv)
    fused = (i.double() * (half * inv).double() + start.double()).float()
    return torch.cat([fused, half[None]])


def make_lidar(town: TownMap, n_beams: int = 360, max_range: float = 60.0,
               fov_deg: float = 360.0):
    """→ ``scan(states) -> (B, n_beams)`` ranges for a fleet: the town's
    walls (built once), every agent's box, and the walkers as 0.5 m squares
    when the world has walkers. ``fov_deg < 360`` gives a forward sector
    scan centred on the ego's heading (``beam_angles``)."""
    b_segs = building_segments(town.buildings)
    rel = beam_angles(n_beams, fov_deg).to(town.buildings.device)

    def scan(states) -> torch.Tensor:
        ap, ay = agent_positions(town, states.agents_route, states.agents_s)
        n_envs = ap.shape[0]
        parts = [b_segs.expand(n_envs, -1, -1, -1), vehicle_segments(ap, ay)]
        if states.peds_s.shape[1] > 0:
            pp = ped_positions(town, states.peds_crossing, states.peds_s)
            parts.append(vehicle_segments(pp, torch.zeros_like(pp[..., 0]),
                                          half_len=0.25, half_wid=0.25))
        segs = torch.cat(parts, dim=1)
        return cast_rays(states.ego_pos, states.ego_yaw[:, None] + rel, segs, max_range)

    return scan


def lidar_image(ranges: torch.Tensor, max_range: float = 60.0) -> torch.Tensor:
    """Ranges → the normalized [0, 1] inverse-depth channel (near = 1)."""
    return 1.0 - torch.clamp(ranges / max_range, 0.0, 1.0)

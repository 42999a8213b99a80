"""Scripted pedestrians: crosswalk and sidewalk walkers, batched (B, P).

A walker is (path id, s ∈ [0, 1], phase). Path ids below
``town.crossings.shape[0]`` ping-pong across that crosswalk with curb
pauses; higher ids stroll sidewalk loop ``id − n_crossings``. ``P`` may be 0
(the default ``SimParams.n_pedestrians``): empty tensors flow through.
"""

from __future__ import annotations

import torch

from perfbench.reference.sim.town import TownMap, norm2

WALK_SPEED = 1.4      # m/s
CURB_WAIT_S = 3.0     # pause at each end before re-crossing
PED_RADIUS = 0.4      # collision half-width


def _sidewalk_point(town: TownMap, loop, s):
    """(B, P) loop ids + (B, P) s ∈ [0, 1) → (B, P, 2)."""
    n = town.sidewalks.shape[1]
    f = torch.remainder(s, 1.0) * n
    i0 = f.to(torch.int64).clamp(0, n - 1)
    i1 = (i0 + 1) % n
    p0 = town.sidewalks[loop, i0]
    p1 = town.sidewalks[loop, i1]
    return p0 + (f - i0)[..., None] * (p1 - p0)


def ped_positions(town: TownMap, path, s):
    """(B, P) path ids + (B, P) s → (B, P, 2) world positions."""
    n_cross = town.crossings.shape[0]
    on_side = path >= n_cross
    segs = town.crossings[torch.clamp(path, max=n_cross - 1)]   # (B, P, 2, 2)
    cross_pos = segs[..., 0, :] + s[..., None] * (segs[..., 1, :] - segs[..., 0, :])
    n_loops = town.sidewalks.shape[0]
    side_pos = _sidewalk_point(town, (path - n_cross).clamp(0, n_loops - 1), s)
    return torch.where(on_side[..., None], side_pos, cross_pos)


def step_pedestrians(town: TownMap, path, s, phase, dt: float,
                     speed: float = WALK_SPEED):
    """One fleet step → (s, phase). |phase| ≥ 1: walking in direction
    sign(phase); |phase| < 1: waiting at a curb, counting up to 1."""
    n_cross = town.crossings.shape[0]
    on_side = path >= n_cross
    seg = town.crossings[torch.clamp(path, max=n_cross - 1)]
    cross_len = norm2(seg[..., 1, :] - seg[..., 0, :])
    n_loops = town.sidewalks.shape[0]
    side_len = town.sidewalk_total[(path - n_cross).clamp(0, n_loops - 1)]
    length = torch.where(on_side, side_len, cross_len) + 1e-6
    walking = torch.abs(phase) >= 1.0
    direction = torch.sign(phase)
    ds = torch.where(walking, direction * speed * dt / length, 0.0)
    s_new = s + ds
    hit_end = walking & ~on_side & ((s_new >= 1.0) | (s_new <= 0.0))
    s_new = torch.where(on_side, torch.remainder(s_new, 1.0), s_new.clamp(0.0, 1.0))
    eps = min(dt / CURB_WAIT_S, 1.0)
    phase_new = torch.where(hit_end, -direction * eps, phase)
    waiting = ~walking
    phase_new = torch.where(
        waiting, torch.sign(phase_new) * torch.clamp(torch.abs(phase_new) + eps, max=1.0),
        phase_new)
    return s_new, phase_new


def spawn_pedestrians(town: TownMap, generator: torch.Generator, n_envs: int,
                      n_peds: int, sidewalk_frac: float = 0.0):
    """→ (path (B, P) int64, s (B, P), phase (B, P)) random walkers drawn
    from ``generator`` (CPU tensors). The draws differ from ``jax.random``;
    only their distribution matches."""
    n_cross = town.crossings.shape[0]
    n_loops = town.sidewalks.shape[0]
    shape = (n_envs, n_peds)
    path = torch.randint(0, n_cross, shape, generator=generator)
    if sidewalk_frac > 0.0 and n_loops > 0:
        loop = torch.randint(n_cross, n_cross + n_loops, shape, generator=generator)
        stroller = torch.rand(shape, generator=generator) < sidewalk_frac
        path = torch.where(stroller, loop, path)
    s = torch.rand(shape, generator=generator)
    direction = torch.where(torch.rand(shape, generator=generator) < 0.5, 1.0, -1.0)
    return path, s, direction  # start walking (|phase| = 1)


def pedestrian_ahead(ego_pos, ego_yaw, peds_pos, stop_distance: float = 12.0,
                     half_width: float = 4.0, mask=None):
    """(B,) True when any walker (B, P, 2) is inside the ego's braking
    corridor; ``mask`` (B, P) restricts which walkers count."""
    rel = peds_pos - ego_pos[:, None, :]
    head = torch.stack([torch.cos(ego_yaw), torch.sin(ego_yaw)], -1)[:, None, :]
    lateral = torch.stack([-head[..., 1], head[..., 0]], -1)
    fwd = (rel * head).sum(-1)
    side = torch.abs((rel * lateral).sum(-1))
    hit = (fwd > 0.0) & (fwd < stop_distance) & (side < half_width)
    if mask is not None:
        hit &= mask
    return hit.any(dim=1)

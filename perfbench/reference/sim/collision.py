"""Collision and off-road checks, batched over envs (leading ``B`` axis)."""

from __future__ import annotations

import torch

from perfbench.reference.sim.town import norm2


def circle_circle(pos_a, radius_a: float, pos_b, radius_b: float):
    """Circles at pos_a (B, 2) vs circles at pos_b (B, N, 2) → (B, N) bool
    overlap."""
    d = pos_b - pos_a[:, None, :]
    r = radius_a + radius_b
    return (d * d).sum(-1) < r * r


def any_vehicle_collision(ego_pos, agents_pos, radius: float):
    """(B,) legacy disc test: the ego's disc of ``radius`` against every
    agent's."""
    return circle_circle(ego_pos, radius, agents_pos, radius).any(dim=1)


def any_building_collision(ego_pos, buildings, radius: float):
    """(B,) legacy disc test against the axis-aligned buildings."""
    return circle_aabb(ego_pos, radius, buildings).any(dim=1)


def circle_aabb(pos, radius: float, boxes):
    """Circles at pos (B, 2) vs boxes (Nb, ≥4: cx, cy, half_w, half_h) →
    (B, Nb) bool overlap."""
    delta = torch.abs(pos[:, None, :] - boxes[:, 0:2])
    closest = torch.clamp(delta - boxes[:, 2:4], min=0.0)
    return (closest * closest).sum(-1) < radius * radius


def point_segment_distance(p, segs):
    """p (B, 2) vs segments (S, 4: x0, y0, x1, y1) → (B, S) distances."""
    a = segs[:, 0:2]
    b = segs[:, 2:4]
    ab = b - a
    t = (((p[:, None, :] - a) * ab).sum(-1)
         / torch.clamp((ab * ab).sum(-1), min=1e-9)).clamp(0.0, 1.0)
    proj = a + t[..., None] * ab
    return norm2(p[:, None, :] - proj)


def offroad(pos, road_segments, half_width, margin: float = 1.5):
    """(B,) True when the point is farther than half_width+margin from
    every road segment."""
    d = point_segment_distance(pos, road_segments)
    return d.amin(dim=1) > half_width + margin


def segment_segment_distance(p1, p2, q1, q2):
    """Min distance between segments [p1, p2] (B, 2) and [q1, q2] (B, A, 2)
    → (B, A). Ericson's closest points of two segments, branchless."""
    d1 = (p2 - p1)[:, None, :]          # (B, 1, 2)
    d2 = q2 - q1                        # (B, A, 2)
    r = p1[:, None, :] - q1             # (B, A, 2)
    a = (d1 * d1).sum(-1)               # (B, 1) > 0
    e = (d2 * d2).sum(-1)               # (B, A) > 0
    f = (d2 * r).sum(-1)
    cc = (d1 * r).sum(-1)
    b = (d1 * d2).sum(-1)
    denom = a * e - b * b
    s = torch.where(denom > 1e-9,
                    ((b * f - cc * e) / torch.clamp(denom, min=1e-9)).clamp(0.0, 1.0),
                    torch.zeros_like(denom))
    t = (b * s + f) / torch.clamp(e, min=1e-9)
    s = torch.where(t < 0.0, -cc / a, torch.where(t > 1.0, (b - cc) / a, s)).clamp(0.0, 1.0)
    t = t.clamp(0.0, 1.0)
    cp1 = p1[:, None, :] + s[..., None] * d1
    cp2 = q1 + t[..., None] * d2
    return norm2(cp1 - cp2)


def heading(yaw):
    return torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)


def capsule_vehicle_collision(ego_pos, ego_yaw, agents_pos, agents_yaw,
                              half_len: float, radius: float):
    """(B,) oriented-capsule overlap of the ego (B, 2)/(B,) with any agent
    (B, A, 2)/(B, A): each vehicle is a segment of half-length ``half_len``
    along its heading, swept by ``radius``."""
    he = heading(ego_yaw)
    p1 = ego_pos - half_len * he
    p2 = ego_pos + half_len * he
    ha = heading(agents_yaw)
    q1 = agents_pos - half_len * ha
    q2 = agents_pos + half_len * ha
    d = segment_segment_distance(p1, p2, q1, q2)
    return (d < 2.0 * radius).any(dim=1)


def capsule_building_collision(ego_pos, ego_yaw, half_len: float,
                               radius: float, boxes):
    """(B,) capsule vs axis-aligned boxes: circle_aabb at 3 points along the
    capsule axis."""
    he = heading(ego_yaw)
    hit = torch.zeros(ego_pos.shape[0], dtype=torch.bool, device=ego_pos.device)
    for tpar in (-1.0, 0.0, 1.0):
        hit |= circle_aabb(ego_pos + tpar * half_len * he, radius, boxes).any(dim=1)
    return hit


def capsule_point_collision(ego_pos, ego_yaw, half_len: float, radius: float,
                            pts, pt_radius: float):
    """(B,) capsule vs circles at pts (B, P, 2) (pedestrians); P may be 0."""
    he = heading(ego_yaw)
    a = (ego_pos - half_len * he)[:, None, :]
    b = (ego_pos + half_len * he)[:, None, :]
    ab = b - a
    t = (((pts - a) * ab).sum(-1)
         / torch.clamp((ab * ab).sum(-1), min=1e-9)).clamp(0.0, 1.0)
    proj = a + t[..., None] * ab
    return (norm2(pts - proj) < radius + pt_radius).any(dim=1)

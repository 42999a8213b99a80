"""Vehicle dynamics: kinematic bicycle with a tire-slip correction.

Elementwise over a batch of vehicles (center-referenced kinematic bicycle,
lr = lf = L/2):
    beta   = atan(0.5 · tan(delta))
    x'     = v · cos(yaw + beta),  y' = v · sin(yaw + beta)
    yaw'   = (v / L) · tan(delta) · cos(beta)
    v'     = throttle·a_max − brake·b_max − c_d·v²
The effective steering is attenuated by the lateral-force saturation factor
1/sqrt(1 + (a_lat/a_grip)²), a_lat = v² tan(delta)/L, and the realized wheel
angle relaxes toward the command at rate ``tire_stiffness`` (1/s).
"""

from __future__ import annotations

import math

import torch

GRAVITY = 9.81
MU = 0.9  # road-tire friction coefficient


def bicycle_step(pos, yaw, v, steer, steer_cmd, throttle, brake, dt: float,
                 wheelbase: float = 2.9, max_accel: float = 4.0,
                 max_brake: float = 8.0, drag: float = 0.05,
                 tire_stiffness: float = 9.0):
    """One integration step: pos (B, 2), the rest (B,) → (pos, yaw, v, steer)."""
    alpha = min(max(tire_stiffness * dt, 0.0), 1.0)
    steer = steer + alpha * (steer_cmd - steer)

    a_lat = v * v * torch.abs(torch.tan(steer)) / wheelbase
    r = a_lat / (MU * GRAVITY)
    g_sat = 1.0 / torch.sqrt(1.0 + r * r)
    eff_steer = steer * g_sat

    beta = torch.atan(0.5 * torch.tan(eff_steer))
    cos_b = torch.cos(beta)
    dx = v * torch.cos(yaw + beta)
    dy = v * torch.sin(yaw + beta)
    dyaw = (v / wheelbase) * torch.tan(eff_steer) * cos_b

    accel = throttle * max_accel - brake * max_brake - drag * v * v
    v_new = torch.clamp(v + accel * dt, min=0.0)

    pos_new = pos + torch.stack([dx, dy], -1) * dt
    yaw_new = torch.remainder(yaw + dyaw * dt + math.pi, 2 * math.pi) - math.pi
    return pos_new, yaw_new, v_new, steer

"""Safety shield: an emergency-brake layer over any policy (the JAX
package's ``training/shield.py``).

A small forward LIDAR fan (``render.lidar``) watches the lane ahead; when
the time to collision falls under a threshold, or anything is inside the
hard standoff, throttle is cut and full brake applied. Steering is never
touched. The shield acts on the executed control only: the recorded
labels stay the policy's own choice, and ``make_rollout`` logs every
intervention as ``traj["shield"]``.
"""

from __future__ import annotations

import dataclasses

import torch

from carla_imitation_learning_tpu_torch.render.lidar import make_lidar
from carla_imitation_learning_tpu_torch.sim.town import TownMap
from carla_imitation_learning_tpu_torch.sim.world import VehicleControl


@dataclasses.dataclass(frozen=True)
class ShieldConfig:
    """Emergency-brake envelope.

    ttc_s: brake when clear distance / speed drops under this many seconds;
    hard_m: brake whenever anything is inside this clear distance;
    fan_deg, n_beams: the forward watch fan; max_range: the sensor horizon;
    standoff: the ego's front overhang (half its 4.5 m length), subtracted
    from the centre-measured ranges so that distance means bumper gap."""

    ttc_s: float = 0.8
    hard_m: float = 3.0
    fan_deg: float = 36.0
    n_beams: int = 7
    max_range: float = 40.0
    standoff: float = 2.25


def make_shield(town: TownMap, cfg: ShieldConfig):
    """→ ``apply(states, control) -> (control, triggered (B,) bool)`` for a
    fleet: ``cfg.n_beams`` rays over the forward ``cfg.fan_deg`` sector
    against walls, agents and walkers; clear = min(ranges) − standoff, ttc
    = clear / max(ego_v, 0.5)."""
    scan = make_lidar(town, n_beams=cfg.n_beams, max_range=cfg.max_range,
                      fov_deg=cfg.fan_deg)

    def apply(states, control: VehicleControl):
        clear = scan(states).amin(dim=-1) - cfg.standoff
        ttc = clear / torch.clamp(states.ego_v, min=0.5)
        triggered = (clear < cfg.hard_m) | (ttc < cfg.ttc_s)
        shielded = dataclasses.replace(
            control, throttle=torch.where(triggered, 0.0, control.throttle),
            brake=torch.where(triggered, 1.0, control.brake))
        return shielded, triggered

    return apply


def shield_from_cfg(cfg) -> ShieldConfig | None:
    """``safety_shield=true`` (with optional ``shield_ttc_s``,
    ``shield_hard_m``, ``shield_fan_deg``, ``shield_n_beams``,
    ``shield_max_range`` and ``shield_standoff`` overrides) → ShieldConfig;
    None when the shield is off."""
    flag = cfg.get("safety_shield", False)
    if isinstance(flag, str):
        flag = flag.strip().lower() not in ("0", "false", "no", "off", "")
    if not flag:
        return None
    d = ShieldConfig()
    return ShieldConfig(
        ttc_s=float(cfg.get("shield_ttc_s", d.ttc_s)),
        hard_m=float(cfg.get("shield_hard_m", d.hard_m)),
        fan_deg=float(cfg.get("shield_fan_deg", d.fan_deg)),
        n_beams=int(cfg.get("shield_n_beams", d.n_beams)),
        max_range=float(cfg.get("shield_max_range", d.max_range)),
        standoff=float(cfg.get("shield_standoff", d.standoff)),
    )

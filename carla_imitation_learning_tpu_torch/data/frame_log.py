"""Autopilot state log and synthetic logs (the JAX package's
``data/frame_log.py``, in numpy as there).

``StateLog`` holds the state.csv columns, one row per frame
(``steer, throttle, brake, trafficlight, current_steer, speed_long,
speed``). ``make_synthetic_state`` and ``synthetic_frames`` draw the same
procedural log as the JAX package from the same seed, so a store built in
either package is the same store. Reading and writing frame folders and
state.csv files is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

STATE_COLUMNS = (
    "steer", "throttle", "brake", "trafficlight", "current_steer", "speed_long", "speed",
)

LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float64)


@dataclasses.dataclass
class StateLog:
    """Columnar autopilot state (one row per frame)."""

    steer: np.ndarray
    throttle: np.ndarray
    brake: np.ndarray
    trafficlight: np.ndarray
    current_steer: np.ndarray
    speed_long: np.ndarray
    speed: np.ndarray

    def __len__(self) -> int:
        return len(self.steer)

    @property
    def sensors(self) -> np.ndarray:
        """(N, 3) float32 sensor vector ``(current_steer, speed_long, speed)``."""
        return np.stack(
            [self.current_steer, self.speed_long, self.speed], axis=-1
        ).astype(np.float32)


def make_synthetic_state(n: int, seed: int = 0) -> StateLog:
    """Plausible autopilot state: piecewise maneuvers with CARLA-like control values."""
    rng = np.random.default_rng(seed)
    steer = np.zeros(n)
    throttle = np.zeros(n)
    brake = np.zeros(n)
    i = 0
    while i < n:
        seg = int(rng.integers(5, 20))
        mode = rng.integers(0, 4)
        if mode == 0:  # cruise full throttle
            throttle[i:i + seg], brake[i:i + seg] = 1.0, 0.0
        elif mode == 1:  # cruise half throttle
            throttle[i:i + seg], brake[i:i + seg] = 0.5, 0.0
        elif mode == 2:  # brake
            throttle[i:i + seg], brake[i:i + seg] = 0.0, 1.0
        else:  # turn while at full throttle
            throttle[i:i + seg], brake[i:i + seg] = 1.0, 0.0
            steer[i:i + seg] = rng.choice([-0.4, 0.4]) * rng.random(min(seg, n - i))
        i += seg
    trafficlight = (rng.random(n) < 0.15).astype(np.float64)
    speed = np.clip(np.cumsum(throttle - brake) * 0.1, 0, 12.0)
    return StateLog(
        steer=steer,
        throttle=throttle,
        brake=brake,
        trafficlight=trafficlight,
        current_steer=steer * 0.9 + rng.normal(0, 0.01, n),
        speed_long=speed * np.cos(steer),
        speed=speed,
    )


def synthetic_frames(n: int, height: int, width: int, seed: int = 0) -> np.ndarray:
    """(N, H, W, 3) uint8 procedural road-like frames with temporal coherence:
    a moving horizon, a road trapezoid that shifts with a latent steering
    signal, and textured noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    drift = np.cumsum(rng.normal(0, 1.5, n))
    ys = np.linspace(0, 1, height)[:, None]
    xs = np.linspace(-1, 1, width)[None, :]
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    for i in range(n):
        horizon = 0.45 + 0.05 * np.sin(t[i] / 17.0)
        sky = (ys < horizon).astype(np.float32)
        center = 0.4 * np.tanh(drift[i] / 50.0)
        half_w = 0.15 + 0.8 * np.clip(ys - horizon, 0, 1)
        road = ((np.abs(xs - center * (1 - ys)) < half_w) & (ys >= horizon)).astype(np.float32)
        r = 40 + 90 * sky + 50 * road
        g = 60 + 120 * sky + 45 * road
        b = 50 + 180 * sky + 55 * road
        noise = rng.normal(0, 6, (height, width))
        out[i] = np.clip(np.stack([r + noise, g + noise, b + noise], -1), 0, 255).astype(np.uint8)
    return out

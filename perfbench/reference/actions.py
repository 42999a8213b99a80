"""Discrete driving-action label semantics (the JAX package's
``data/actions.py``): 9 classes = accel class · 3 + steer class.

- steer class: 2 if steer > +0.05, 0 if steer < −0.05, else 1;
- accel class from (brake, throttle): 2 for (0, 1.0), 1 for (0, 0.5), 0 for
  (1, 0); other pairs keep the raw brake value, as the reference does.
"""

from __future__ import annotations

import torch

STEER_THRESHOLD = 0.05

# steer classes {0,1,2} → wheel direction {-1, 0, +1}; accel classes
# {0,1,2} → (throttle, brake) = {(0,1), (0.5,0), (1,0)}
ACTION_STEER = (-1.0, 0.0, 1.0)
ACTION_ACCEL = ((0.0, 1.0), (0.5, 0.0), (1.0, 0.0))


def steer_to_class(steer, threshold: float = STEER_THRESHOLD):
    return torch.where(steer > threshold, 2, torch.where(steer < -threshold, 0, 1))


def accel_to_class(throttle, brake):
    acc = brake * 1.0
    acc = torch.where((brake == 0.0) & (throttle == 1.0), 2.0, acc)
    acc = torch.where((brake == 0.0) & (throttle == 0.5), 1.0, acc)
    acc = torch.where((brake == 1.0) & (throttle == 0.0), 0.0, acc)
    return acc


def continuous_to_discrete(steer, throttle, brake,
                           threshold: float = STEER_THRESHOLD):
    """Continuous controls → 9-class action index (float, as the reference)."""
    return accel_to_class(throttle, brake) * 3 + steer_to_class(steer, threshold)


def control_to_discrete_label(steer, throttle, brake,
                              threshold: float = STEER_THRESHOLD):
    """9-class int64 label of a continuous control anywhere in the control
    square (what the closed loop logs as ``traj["action"]`` for a
    continuous policy): the steer class as ``steer_to_class``; the accel
    class 0 where brake > throttle, 2 where throttle > 0.75, else 1. On the
    reference table's exact pairs it agrees with ``continuous_to_discrete``."""
    accel = torch.where(brake > throttle, 0, torch.where(throttle > 0.75, 2, 1))
    return (accel * 3 + steer_to_class(steer, threshold)).to(torch.int64)


def discrete_to_continuous(action):
    """Class index → (steer, throttle, brake) float32 tensors."""
    action = action.to(torch.int64)
    steer_tab = torch.tensor(ACTION_STEER, device=action.device)
    accel_tab = torch.tensor(ACTION_ACCEL, device=action.device)
    accel = accel_tab[action // 3]
    return steer_tab[action % 3], accel[..., 0], accel[..., 1]

"""Recurrent driving policy: ConvTrunk embedding → GRU → action head (the
JAX package's ``models/rnn_policy.py``).

The trunk runs once over all B · T frames of a sequence batch, then the GRU
cell (flax's layout, ``models.rnn``, computing in ``dtype``) loops over T.
The hidden state starts at zeros in the parameters' dtype (float32) and
stays in it under bf16 compute. In the closed loop the state rides the
rollout's policy carry (``make_rollout(policy_carry_init=...)``) and is
reset to zeros on every auto-reset.
"""

from __future__ import annotations

import torch
from torch import nn

from carla_imitation_learning_tpu_torch.models.cnn import ConvTrunk, MLPHead
from carla_imitation_learning_tpu_torch.models.rnn import GRUCell


class RecurrentPolicy(nn.Module):
    """Training: ``model(frames_seq (B, T, H, W, C), h0=None)`` → (logits
    (B, T, n_actions) float32, h_final (B, hidden)). Rollout:
    ``model.step(h (B, hidden), obs (B, H, W, C))`` → (h', logits (B,
    n_actions))."""

    def __init__(self, obs_size: int = 1, hidden: int = 128, n_actions: int = 9,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden = hidden
        self.trunk = ConvTrunk(in_channels=obs_size, dtype=dtype)
        self.cell = GRUCell(128, hidden, dtype=dtype)
        self.head = MLPHead(hidden, (64, n_actions), dtype=dtype)

    def initial_state(self, batch: int, device=None) -> torch.Tensor:
        return self.cell.initial_state(batch, device)

    def forward(self, frames_seq: torch.Tensor, h0: torch.Tensor | None = None):
        b, t = frames_seq.shape[:2]
        emb = self.trunk(frames_seq.reshape((b * t,) + tuple(frames_seq.shape[2:])))
        emb = emb.reshape(b, t, -1)
        h = self.initial_state(b, frames_seq.device) if h0 is None else h0
        logits = []
        for i in range(t):
            h, out = self.cell(h, emb[:, i])
            logits.append(self.head(out))
        return torch.stack(logits, dim=1), h

    def step(self, h: torch.Tensor, obs: torch.Tensor):
        h, out = self.cell(h, self.trunk(obs))
        return h, self.head(out)

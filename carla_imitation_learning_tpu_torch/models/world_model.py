"""Latent world model: encoder → RNN (LSTM or GRU) → decoder (the JAX
package's ``models/world_model.py``).

- ``FrameEncoder``: a SAME k4 s2 pyramid (32, 64, 128, 128; H → H/16) in
  ``dtype``, flattened in NHWC order, a Dense in the parameters' dtype
  (float32) and tanh, so latents lie in [−1, 1];
- ``FrameDecoder``: a Dense to an (H/16, W/16, 128) map read in NHWC order,
  then four SAME k4 s2 transposed convs (128, 64, 32, C), the last ending
  in a float32 sigmoid. SAME k4 s2 is torch's ``padding=1``; ``convert``
  flips the flax kernels (see ``models/aux.py``);
- ``LatentWorldModel``: per-frame latents z_t, an action-conditioned cell
  (``models.rnn``, computing in the parameters' dtype as flax's cells
  without a ``dtype`` do) predicting ẑ_{t+1} from (z_t, a_t), and the
  decoder. Discrete actions are one-hot (``n_actions`` wide), continuous
  ones the (steer, accel) rows as given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from carla_imitation_learning_tpu_torch.models.cnn import _same_pads
from carla_imitation_learning_tpu_torch.models.rnn import GRUCell, LSTMCell

_ENC_CHANNELS = (32, 64, 128, 128)
_DEC_CHANNELS = (128, 64, 32)


def _same_out(size: int) -> int:
    for _ in _ENC_CHANNELS:
        size = -(-size // 2)
    return size


class FrameEncoder(nn.Module):
    def __init__(self, channels: int = 1, height: int = 64, width: int = 64,
                 z_size: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        ins = (channels,) + _ENC_CHANNELS[:-1]
        self.convs = nn.ModuleList(nn.Conv2d(i, o, 4, stride=2)
                                   for i, o in zip(ins, _ENC_CHANNELS))
        self.dense = nn.Linear(_same_out(height) * _same_out(width) * _ENC_CHANNELS[-1], z_size)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, z) tanh latents in the parameters' dtype."""
        dt = self.dtype
        h = x.to(dt).permute(0, 3, 1, 2)
        for conv in self.convs:
            ph, pw = _same_pads(h.shape[2], 4, 2), _same_pads(h.shape[3], 4, 2)
            h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
            h = F.relu(F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), stride=2))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        w = self.dense.weight
        return torch.tanh(F.linear(h.to(w.dtype), w, self.dense.bias))


class FrameDecoder(nn.Module):
    def __init__(self, height: int = 64, width: int = 64, channels: int = 1,
                 z_size: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.seed_hw = (height // 16, width // 16)
        self.seed = nn.Linear(z_size, self.seed_hw[0] * self.seed_hw[1] * 128)
        ins = (128,) + _DEC_CHANNELS
        outs = _DEC_CHANNELS + (channels,)
        self.deconvs = nn.ModuleList(nn.ConvTranspose2d(i, o, 4, stride=2, padding=1)
                                     for i, o in zip(ins, outs))
        self.dtype = dtype

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, z) → (B, H, W, C) sigmoid frames in the parameters' dtype."""
        dt = self.dtype
        h = F.linear(z.to(dt), self.seed.weight.to(dt), self.seed.bias.to(dt))
        h = h.reshape(h.shape[0], *self.seed_hw, 128).permute(0, 3, 1, 2)
        last = len(self.deconvs) - 1
        for i, deconv in enumerate(self.deconvs):
            h = F.conv_transpose2d(h, deconv.weight.to(dt), deconv.bias.to(dt), stride=2,
                                   padding=1)
            h = F.relu(h) if i < last else torch.sigmoid(h.to(self.seed.weight.dtype))
        return h.permute(0, 2, 3, 1)


class LatentWorldModel(nn.Module):
    def __init__(self, z_size: int = 64, rnn: str = "lstm", n_actions: int = 9,
                 height: int = 64, width: int = 64, channels: int = 1,
                 hidden_size: int = 256, dtype: torch.dtype = torch.bfloat16,
                 action_space: str = "discrete"):
        super().__init__()
        if rnn not in ("lstm", "gru"):
            raise ValueError(f"rnn must be 'lstm' or 'gru', got {rnn!r}")
        if action_space not in ("discrete", "continuous"):
            raise ValueError(
                f"action_space must be 'discrete' or 'continuous', got {action_space!r}")
        self.z_size, self.rnn, self.n_actions = z_size, rnn, n_actions
        self.height, self.width, self.channels = height, width, channels
        self.hidden_size, self.dtype, self.action_space = hidden_size, dtype, action_space
        self.encoder = FrameEncoder(channels, height, width, z_size, dtype)
        self.decoder = FrameDecoder(height, width, channels, z_size, dtype)
        cell_cls = LSTMCell if rnn == "lstm" else GRUCell
        self.cell = cell_cls(z_size + self.action_width, hidden_size)
        self.to_z = nn.Linear(hidden_size, z_size)

    @property
    def action_width(self) -> int:
        return self.n_actions if self.action_space == "discrete" else 2

    def action_input(self, actions: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """(…) int ids → one-hot rows, or (…, 2) controls as given, in
        ``like``'s dtype (float32 unless a reference runs in float64)."""
        if self.action_space == "discrete":
            return F.one_hot(actions.to(torch.int64), self.n_actions).to(like.dtype)
        return actions.to(like.dtype)

    def initial_carry(self, batch: int, device=None):
        return self.cell.initial_state(batch, device)

    def dynamics_step(self, carry, z: torch.Tensor, a: torch.Tensor):
        """One latent step from (z, a) rows (a one-hot or relaxed, or
        controls): → (carry', ẑ clipped to the encoder's range [−1, 1])."""
        carry, h = self.cell(carry, torch.cat([z, a.to(z.dtype)], dim=-1))
        return carry, torch.clamp(self.to_z(h), -1.0, 1.0)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) → (B, T, z)."""
        b, t = frames.shape[:2]
        return self.encoder(frames.reshape((b * t,) + tuple(frames.shape[2:]))).reshape(
            b, t, self.z_size)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T, z) → (B, T, H, W, C)."""
        b, t = z.shape[:2]
        x = self.decoder(z.reshape(b * t, self.z_size))
        return x.reshape((b, t) + tuple(x.shape[1:]))

    def predict_latents(self, z: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        """(B, T, z) + (B, T) actions (or (B, T, 2) controls) → (B, T, z)
        one-step predictions; output[:, t] predicts z[:, t + 1]."""
        inp = torch.cat([z, self.action_input(actions, z)], dim=-1)
        carry = self.initial_carry(z.shape[0], z.device)
        hidden = []
        for t in range(inp.shape[1]):
            carry, h = self.cell(carry, inp[:, t])
            hidden.append(h)
        return self.to_z(torch.stack(hidden, dim=1))

    def imagine(self, z0: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        """Open-loop imagination: (B, z) start + (B, H) action plan → (B, H,
        z), each prediction clipped to [−1, 1] and fed back as the next
        input."""
        a = self.action_input(actions, z0)
        carry, z, zs = self.initial_carry(z0.shape[0], z0.device), z0, []
        for t in range(a.shape[1]):
            carry, z = self.dynamics_step(carry, z, a[:, t])
            zs.append(z)
        return torch.stack(zs, dim=1)

    def imagine_frames(self, frames0: torch.Tensor, actions: torch.Tensor):
        """(B, H, W, C) frame + (B, H_steps) plan → (latents (B, H_steps, z),
        decoded frames (B, H_steps, H, W, C))."""
        zs = self.imagine(self.encoder(frames0), actions)
        return zs, self.decode(zs)

    def forward(self, frames: torch.Tensor, actions: torch.Tensor):
        """frames (B, T, H, W, C), actions (B, T) → (recon (B, T, H, W, C),
        z (B, T, z), z_pred (B, T − 1, z), frames_pred (B, T − 1, H, W, C))."""
        z = self.encode(frames)
        recon = self.decode(z)
        z_pred = self.predict_latents(z, actions)[:, :-1]
        return recon, z, z_pred, self.decode(z_pred)

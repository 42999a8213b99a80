"""Multi-task BC net with sensor fusion (the JAX package's ``models/aux.py``).

The frames go through the ConvNet1 trunk, the sensor vector (current_steer,
speed_long, speed) through a (32, 32) MLP; the fused 128 features drive a
transposed-conv reconstruction decoder, a traffic-light classifier, the
9-way action classifier and, with ``seg_classes`` > 0, a per-pixel
semantic-segmentation decoder. Compute runs in ``dtype`` with float32
parameters; the reconstruction's sigmoid and the seg logits are float32.

Transposed convolutions: flax's ``nn.ConvTranspose`` (``transpose_kernel=
False``) correlates the stride-dilated input with its (kh, kw, in, out)
kernel as stored; torch's ``conv_transpose2d`` correlates with the kernel
flipped in both spatial axes. ``convert`` flips and transposes the kernel,
and lax's SAME padding at k4 s2 (2 on each side of the dilated input) is
torch's ``padding=1``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from carla_imitation_learning_tpu_torch.models.cnn import ConvTrunk, MLPHead


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class ReconDecoder(nn.Module):
    """(B, F) features → (B, out_hw, out_hw, out_channels): a Dense layer to
    a 4×4×64 seed, then k4 s2 transposed convs doubling the size up to
    ``out_hw`` (channels 64, 64, 32, 32, 16, 16, 16 cut to the number of
    doublings, the last one ``out_channels``), ReLU between them. The
    output is the sigmoid in float32, or float32 logits with
    ``logits_out``."""

    def __init__(self, in_features: int, out_hw: int = 256, out_channels: int = 4,
                 seed_hw: int = 4, logits_out: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        n_ups = (out_hw // seed_hw).bit_length() - 1
        chans = [64, 64, 32, 32, 16, 16, 16][:n_ups - 1] + [out_channels]
        self.seed_hw = seed_hw
        self.logits_out = logits_out
        self.dtype = dtype
        self.seed = nn.Linear(in_features, seed_hw * seed_hw * 64)
        ins = [64] + chans[:-1]
        self.deconvs = nn.ModuleList(nn.ConvTranspose2d(i, o, 4, stride=2, padding=1)
                                     for i, o in zip(ins, chans))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = _linear(feat, self.seed, dt)
        h = h.reshape(h.shape[0], self.seed_hw, self.seed_hw, 64).permute(0, 3, 1, 2)
        last = len(self.deconvs) - 1
        for i, deconv in enumerate(self.deconvs):
            h = F.conv_transpose2d(h, deconv.weight.to(dt), deconv.bias.to(dt),
                                   stride=2, padding=1)
            if i < last:
                h = F.relu(h)
        h = h.to(torch.promote_types(dt, torch.float32)).permute(0, 2, 3, 1)
        return h if self.logits_out else torch.sigmoid(h)


class AuxNet(nn.Module):
    """``(frames (B, H, W, obs_size), sensor (B, sensor_dim))`` →
    ``(recon (B, H, W, obs_size), traffic logits (B, n_traffic_classes),
    action logits (B, n_actions))``, plus seg logits (B, H, W,
    seg_classes) when ``seg_classes`` > 0. ``image_hw`` is the square
    input's side, a power of two times 4."""

    def __init__(self, obs_size: int = 4, n_actions: int = 9, n_traffic_classes: int = 2,
                 sensor_dim: int = 3, image_hw: int = 256, seg_classes: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.obs_size, self.sensor_dim, self.image_hw = obs_size, sensor_dim, image_hw
        self.dtype = dtype
        self.trunk = ConvTrunk(in_channels=obs_size, dtype=dtype)
        self.sensor_fc1 = nn.Linear(sensor_dim, 32)
        self.sensor_fc2 = nn.Linear(32, 32)
        self.fuse_fc = nn.Linear(128 + 32, 128)
        self.recon = ReconDecoder(128, out_hw=image_hw, out_channels=obs_size, dtype=dtype)
        self.traffic_head = MLPHead(128, (32, n_traffic_classes), dtype=dtype)
        self.action_head = MLPHead(128, (64, 32, n_actions), dtype=dtype)
        self.seg = (ReconDecoder(128, out_hw=image_hw, out_channels=seg_classes,
                                 logits_out=True, dtype=dtype) if seg_classes > 0 else None)

    def forward(self, frames: torch.Tensor, sensor: torch.Tensor):
        dt = self.dtype
        feat = self.trunk(frames)
        s = F.relu(_linear(sensor, self.sensor_fc1, dt))
        s = F.relu(_linear(s, self.sensor_fc2, dt))
        fused = F.relu(_linear(torch.cat([feat, s], dim=-1), self.fuse_fc, dt))
        outs = (self.recon(fused), self.traffic_head(fused), self.action_head(fused))
        if self.seg is not None:
            outs += (self.seg(fused),)
        return outs

    def example_input(self, batch: int = 1, device: str | torch.device = "cpu"):
        return (torch.zeros(batch, self.image_hw, self.image_hw, self.obs_size, device=device),
                torch.zeros(batch, self.sensor_dim, device=device))

    def as_policy_fn(self):
        """The closed loop's ``policy_fn(obs, extras) -> actions``: the
        rollout's sensor vector ``extras["sensor"]`` feeds the fusion MLP
        and the action head's argmax drives."""

        @torch.no_grad()
        def policy_fn(obs, extras):
            return self(obs, extras["sensor"])[2].argmax(-1)

        return policy_fn

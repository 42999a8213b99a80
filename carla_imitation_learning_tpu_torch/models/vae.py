"""Convolutional VAE (the JAX package's ``models/vae.py``; the reference's
CNNAutoEncoder).

At the reference size, 1×224×224, the encoder is four VALID convs (32 k4
s2, 64 k4 s2, 128 k6 s3, 128 k6 s3: 224→111→54→17→4, hidden 4·4·128 =
2048), the bottleneck two float32 Dense layers to (mu, log_var) of
``z_size`` and a Dense back to ``hidden``, and the decoder five VALID
transposed convs from a 1×1×hidden map (128 k6 s2, 128 k6 s2, 64 k6 s2, 32
k6 s3, C k4 s2: 1→6→16→36→111→224) ending in a float32 sigmoid. Other sizes
(multiples of 16) use a SAME k4 s2 pyramid, H → H/16 → H.

The JAX module flattens and reshapes its maps in NHWC; this one computes in
NCHW and permutes before the flatten and after the reshape, so the Dense
layers see the JAX package's feature order. VALID transposed convs are
torch's ``padding=0`` (k ≥ s in every layer), SAME k4 s2 is ``padding=1``;
``convert`` flips the flax kernels (see ``models/aux.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from carla_imitation_learning_tpu_torch.models.cnn import _same_pads


def _conv_out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


def draw_noise(generator: torch.Generator, shape: tuple, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """The reparameterisation's standard normal draw, on the generator's
    device, moved to ``device``."""
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=dtype).to(device)


class ConvVAE(nn.Module):
    def __init__(self, channels: int = 1, height: int = 224, width: int = 224,
                 z_size: int = 32, enc_channels: Sequence[int] = (32, 64, 128, 128),
                 enc_kernels: Sequence[int] = (4, 4, 6, 6),
                 enc_strides: Sequence[int] = (2, 2, 3, 3),
                 dec_channels: Sequence[int] = (128, 128, 64, 32),
                 dec_kernels: Sequence[int] = (6, 6, 6, 6, 4),
                 dec_strides: Sequence[int] = (2, 2, 2, 3, 2),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.channels, self.height, self.width = channels, height, width
        self.z_size = z_size
        self.enc_channels = tuple(enc_channels)
        self.dtype = dtype
        if self.reference_chain:
            h, w = height, width
            for k, s in zip(enc_kernels, enc_strides):
                h, w = _conv_out(h, k, s), _conv_out(w, k, s)
            self.feature_hw = (h, w)
            enc = list(zip(self.enc_channels, enc_kernels, enc_strides))
            dec = list(zip(tuple(dec_channels) + (channels,), dec_kernels, dec_strides))
            dec_in = self.hidden_size
        else:
            if height % 16 or width % 16:
                raise ValueError("non-224 ConvVAE sizes must be multiples of 16")
            self.feature_hw = (height // 16, width // 16)
            enc = [(c, 4, 2) for c in self.enc_channels]
            dec = [(c, 4, 2) for c in (128, 64, 32, channels)]
            dec_in = self.enc_channels[-1]
        self.enc_geometry = [(k, s) for _, k, s in enc]
        self.dec_geometry = [(k, s) for _, k, s in dec]
        ins = [channels] + [c for c, _, _ in enc[:-1]]
        self.encoder = nn.ModuleList(nn.Conv2d(i, c, k, stride=s)
                                     for i, (c, k, s) in zip(ins, enc))
        self.to_mu = nn.Linear(self.hidden_size, z_size)
        self.to_log_var = nn.Linear(self.hidden_size, z_size)
        self.z_to_hidden = nn.Linear(z_size, self.hidden_size)
        pad = 0 if self.reference_chain else 1
        ins = [dec_in] + [c for c, _, _ in dec[:-1]]
        self.decoder = nn.ModuleList(nn.ConvTranspose2d(i, c, k, stride=s, padding=pad)
                                     for i, (c, k, s) in zip(ins, dec))

    @property
    def reference_chain(self) -> bool:
        """True at the reference design size (224²): the VALID chain."""
        return (self.height, self.width) == (224, 224)

    @property
    def hidden_size(self) -> int:
        """Flattened encoder output size (2048 at 224²)."""
        h, w = self.feature_hw
        return h * w * self.enc_channels[-1]

    @property
    def _param_float(self) -> torch.dtype:
        return self.to_mu.weight.dtype

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, hidden) in float32 (the parameters' dtype)."""
        dt = self.dtype
        h = x.to(dt).permute(0, 3, 1, 2)
        for conv, (k, s) in zip(self.encoder, self.enc_geometry):
            if not self.reference_chain:
                ph, pw = _same_pads(h.shape[2], k, s), _same_pads(h.shape[3], k, s)
                h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
            h = F.relu(F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), stride=s))
        return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1).to(self._param_float)

    def bottleneck(self, h: torch.Tensor, generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None):
        """(B, hidden) → (z, mu, log_var), all in float32: z = mu without a
        draw, else mu + exp(log_var / 2) · ε with ε the ``noise`` tensor
        given, or a standard normal from ``generator``."""
        mu = F.linear(h, self.to_mu.weight, self.to_mu.bias)
        log_var = F.linear(h, self.to_log_var.weight, self.to_log_var.bias)
        if noise is None and generator is not None:
            noise = draw_noise(generator, tuple(mu.shape), mu.device, mu.dtype)
        if noise is None:
            return mu, mu, log_var
        return mu + torch.exp(0.5 * log_var) * noise.to(mu.dtype), mu, log_var

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, z_size) → (B, H, W, C) sigmoid in float32."""
        dt = self.dtype
        h = F.linear(z.to(dt), self.z_to_hidden.weight.to(dt), self.z_to_hidden.bias.to(dt))
        if self.reference_chain:
            h = h.reshape(h.shape[0], self.hidden_size, 1, 1)
        else:
            fh, fw = self.feature_hw
            h = h.reshape(h.shape[0], fh, fw, self.enc_channels[-1]).permute(0, 3, 1, 2)
        last = len(self.decoder) - 1
        for i, (deconv, (k, s)) in enumerate(zip(self.decoder, self.dec_geometry)):
            h = F.conv_transpose2d(h, deconv.weight.to(dt), deconv.bias.to(dt), stride=s,
                                   padding=deconv.padding)
            h = F.relu(h) if i < last else torch.sigmoid(h.to(self._param_float))
        return h.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None):
        """x (B, H, W, C) in [0, 1] → (recon, mu, log_var)."""
        z, mu, log_var = self.bottleneck(self.encode(x), generator, noise)
        return self.decode(z), mu, log_var

    def representation(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic latent embedding (mu)."""
        return self.bottleneck(self.encode(x))[1]

    def example_input(self, batch: int = 1, device: str | torch.device = "cpu"):
        return torch.zeros(batch, self.height, self.width, self.channels, device=device)

"""Command-conditioned branched policy with a speed head (the JAX
package's ``models/cil.py``).

Every command branch is computed at once by two batched products and the
active branch is picked by a one-hot contraction in float32, so no branch
depends on the data. The branch tensors keep the JAX package's layouts
(``branch_w1`` (K, F, H), ``branch_b1`` (K, H), ``branch_w2`` (K, H, A),
``branch_b2`` (K, A)), so converting flax parameters copies them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from carla_imitation_learning_tpu_torch.models.cnn import ConvTrunk


class BranchedCILPolicy(nn.Module):
    """(frames (B, H, W, obs_size), speed (B,), command (B,) int) →
    (action logits (B, n_actions) float32, predicted speed (B,) float32).

    The speed goes through Dense(32) and ReLU, joins the 128 trunk
    features, then Dense(128) and ReLU; the K branches (Dense(H), ReLU,
    Dense(A)) run in ``dtype`` with float32 biases; the speed head is a
    float32 Dense(1) on the trunk features. A command outside [0, K) picks
    no branch (zero logits), as the JAX package's scatter drops it; clip it
    first (``as_policy_fn`` does)."""

    # the branch kernels flax draws with lecun_normal (fan-in over all but
    # the last axis) and the biases it zeroes (``steps.flax_init_``)
    flax_kernels = ("branch_w1", "branch_w2")
    flax_biases = ("branch_b1", "branch_b2")

    def __init__(self, obs_size: int = 4, n_actions: int = 9, n_commands: int = 4,
                 branch_hidden: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_commands = n_commands
        self.dtype = dtype
        self.trunk = ConvTrunk(in_channels=obs_size, dtype=dtype)
        self.speed_fc = nn.Linear(1, 32)
        self.fuse_fc = nn.Linear(128 + 32, 128)
        self.branch_w1 = nn.Parameter(torch.zeros(n_commands, 128, branch_hidden))
        self.branch_b1 = nn.Parameter(torch.zeros(n_commands, branch_hidden))
        self.branch_w2 = nn.Parameter(torch.zeros(n_commands, branch_hidden, n_actions))
        self.branch_b2 = nn.Parameter(torch.zeros(n_commands, n_actions))
        self.speed_head = nn.Linear(128, 1)

    def forward(self, frames: torch.Tensor, speed: torch.Tensor, command: torch.Tensor):
        dt = self.dtype
        feat = self.trunk(frames)                                        # (B, 128)
        v = F.relu(F.linear(speed[:, None].to(dt), self.speed_fc.weight.to(dt),
                            self.speed_fc.bias.to(dt)))
        fused = torch.cat([feat, v], dim=-1)
        fused = F.relu(F.linear(fused, self.fuse_fc.weight.to(dt), self.fuse_fc.bias.to(dt)))
        # the compute-dtype product plus the float32 bias promotes to float32,
        # and the second product takes the float32 activations with the
        # kernel rounded to the compute dtype, as jnp.einsum promotes them
        h = F.relu(torch.einsum("bf,kfh->bkh", fused, self.branch_w1.to(dt)) + self.branch_b1)
        w2 = self.branch_w2.to(dt).to(h.dtype)
        logits_all = torch.einsum("bkh,kha->bka", h, w2) + self.branch_b2   # (B, K, A)
        K = self.n_commands
        cmd = command.to(torch.int64)
        cmd = torch.where(cmd < 0, cmd + K, cmd)
        onehot = (cmd[:, None] == torch.arange(K, device=cmd.device)).to(logits_all.dtype)
        logits = torch.einsum("bka,bk->ba", logits_all, onehot)
        w = self.speed_head.weight
        pred_speed = F.linear(feat.to(w.dtype), w, self.speed_head.bias)[:, 0]
        return logits, pred_speed

    def as_policy_fn(self):
        """The closed loop's ``policy_fn(obs, extras) -> actions`` for this
        model: the rollout's navigation command clipped (not wrapped) into
        [0, n_commands − 1], the speed as the second input, argmax of the
        active branch's logits."""

        @torch.no_grad()
        def policy_fn(obs, extras):
            cmd = torch.clamp(extras["command"], 0, self.n_commands - 1)
            logits, _ = self(obs, extras["speed"], cmd)
            return logits.argmax(-1)

        return policy_fn

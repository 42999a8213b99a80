"""Behaviour cloning's step in plain PyTorch: the frame windows gathered
from the raw frames, mean softmax cross-entropy, clipping of all gradients
together to a global norm (optax's rule: scaled by max / norm when the
norm is at or above max), then Adam (b1 0.9, b2 0.999, eps 1e-8, bias
corrected), all in float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def windows(frames: torch.Tensor, actions: torch.Tensor, idx: torch.Tensor,
            frame_skip: int = 4):
    """Sample indices (B,) → (x (B, H, W, frame_skip) float32 in [0, 1], y
    (B,)): frames idx .. idx + frame_skip − 1 and the action of frame idx +
    frame_skip."""
    steps = torch.arange(frame_skip, device=idx.device)
    x = frames[idx[:, None] + steps[None, :]].permute(0, 2, 3, 1).to(torch.float32) / 255.0
    return x, actions[idx + frame_skip].to(torch.int64)


def bc_steps(forward, params: dict, batches, lr: float = 1e-3, clip: float = 0.5,
             betas=(0.9, 0.999), eps: float = 1e-8, moments=None):
    """Adam steps from ``params`` over ``batches`` [(x, y), ...] with
    ``forward(w, x) -> logits`` → (losses [float], first clipped gradient
    {name: tensor}, final parameters {name: tensor}). Adam starts from
    nothing, or from ``moments`` = (first {name: tensor}, second {name:
    tensor}, steps already taken)."""
    p = {k: v.detach().clone().to(torch.float32) for k, v in params.items()}
    if moments is None:
        moments = ({k: torch.zeros_like(v) for k, v in p.items()},
                   {k: torch.zeros_like(v) for k, v in p.items()}, 0)
    m = {k: v.to(torch.float32) for k, v in moments[0].items()}
    v2 = {k: v.to(torch.float32) for k, v in moments[1].items()}
    losses, first_grad = [], None
    for t, (x, y) in enumerate(batches, start=int(moments[2]) + 1):
        leaves = {k: a.requires_grad_(True) for k, a in p.items()}
        loss = F.cross_entropy(forward(leaves, x).to(torch.float32), y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        g = {k: gr.detach() for k, gr in zip(leaves, grads)}
        norm = torch.sqrt(sum((gr.double() ** 2).sum() for gr in g.values())).float()
        if clip > 0 and norm >= clip:
            g = {k: gr / norm * clip for k, gr in g.items()}
        if first_grad is None:
            first_grad = g
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k in p:
                m[k] = betas[0] * m[k] + (1 - betas[0]) * g[k]
                v2[k] = betas[1] * v2[k] + (1 - betas[1]) * g[k] ** 2
                mh = m[k] / (1 - betas[0] ** t)
                vh = v2[k] / (1 - betas[1] ** t)
                p[k] = (p[k] - lr * mh / (torch.sqrt(vh) + eps)).detach()
    return losses, first_grad, p

"""int8 inference for the serving tier (the JAX package's
``serving/quant.py``).

- **Weights**: symmetric per-output-channel int8, scale = max|w| / 127 per
  output feature (floored at 1e-8 / 127), baked once into the model copy
  that ``quantize_params`` returns, so an export carries int8 weights.
- **Activations**: symmetric per-sample int8, scale from each sample's own
  max|x|: a sample's logits do not depend on its batchmates, so engine
  padding cannot change them.
- **Contractions**: int8 × int8 → int32 (``torch._int_mm``; a convolution is
  lowered to patches first), then ``y.float() * (sx * sw)``, then the bias
  in float32.

Rounding is half to even and codes are clipped to ±127, as in the JAX
package, and the scales are computed in the forms its shipped program
computes them: the weight scales eagerly (``max / 127``, a true division)
and the activation scales under ``jit`` (``max · float32(1/127)``, the
division XLA rewrites). The divisions here divide by tensors on the
device (the card turns a division by a host scalar into a multiply), so
the card gives the CPU's codes.

Which layers go int8 is exactly the JAX package's: every ``nn.Conv2d``
(the policies' convs have no padding, dilation or groups; a conv that does
raises) and every ``nn.Linear`` — what the JAX package intercepts as
``nn.Conv`` and ``nn.Dense``. CIL's branch products stay float. An int8
layer returns float32 whatever the model's compute dtype, so the relu and
pool after it run in float32, as the JAX package's intercepted layers do.
The models reach their layers through ``models.cnn.conv2d`` and
``linear``, which call an int8 layer in place of the float one, so
``quantize_params`` is a module swap on a copy of the model.

``ViTPolicy`` raises: the JAX package bakes its attention kernels to int8
codes too but never swaps those layers, so its int8 ViT multiplies by the
codes as if they were weights (ROADMAP Queue 3).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from carla_imitation_learning_tpu_torch.models import (
    BranchedCILPolicy, ContinuousPolicyCNN, DualStreamCNN, PolicyCNN, ViTPolicy,
)
from carla_imitation_learning_tpu_torch.models.cnn import s2d_stem_kernel_inverse

# the families whose every contraction is a conv, a linear or (CIL) a float
# branch product
SUPPORTED = (PolicyCNN, ContinuousPolicyCNN, DualStreamCNN, BranchedCILPolicy)
_ROWS_PAD = 16   # _int_mm on the card wants more than 16 rows


def _quant_dynamic(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-sample int8 of ``x`` (B, ...) → (codes, scale (B, 1, ...))
    with x ≈ codes · scale."""
    x = x.float()
    amax = x.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)   # XLA's compiled form
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def _quant_kernel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a weight whose first axis is the
    output (torch's layout) → (codes, scale (out,))."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = torch.clamp(amax, min=1e-8) / w.new_tensor(127.0)
    codes = torch.clamp(torch.round(w / scale.view((-1,) + (1,) * (w.dim() - 1))), -127, 127)
    return codes.to(torch.int8), scale


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 × (N, K) int8 transposed → (M, N) int32, through
    ``torch._int_mm``. Zero columns take K and N to multiples of 8 and 16
    zero rows keep M above 16, as cuBLASLt's int8 GEMM needs; zeros leave
    the int32 sums unchanged."""
    if a.dtype != torch.int8 or b_t.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} and {b_t.dtype}")
    m, k = a.shape
    n = b_t.shape[0]
    kp, np_ = -k % 8, -n % 8
    a = torch.nn.functional.pad(a, (0, kp, 0, _ROWS_PAD))
    b_t = torch.nn.functional.pad(b_t, (0, kp, 0, np_))
    return torch._int_mm(a, b_t.t())[:m, :n]


class Int8Conv2d(nn.Module):
    """An ``nn.Conv2d`` (no padding, dilation or groups) with pre-baked int8
    weights: ``forward(x, stride, s2d_inverse)`` on NCHW ``x`` → float32."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        if (conv.padding not in ((0, 0), "valid") or conv.dilation != (1, 1)
                or conv.groups != 1):
            raise ValueError(
                f"{conv}: a conv with padding, dilation or groups has no int8 path "
                "(the JAX package's _conv_supported keeps only string-padded, "
                "undilated, ungrouped convs)")
        q, s = _quant_kernel(conv.weight.detach())
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", s)
        self.register_buffer("bias", conv.bias.detach().float().clone())

    def forward(self, x: torch.Tensor, stride: int, s2d_inverse: bool = False) -> torch.Tensor:
        xq, sx = _quant_dynamic(x)
        wq, sw = self.weight_q, self.weight_scale
        if s2d_inverse:   # a permutation of the codes, dropping zero taps
            wq = s2d_stem_kernel_inverse(wq)
        b, c, _, _ = xq.shape
        o, _, k, _ = wq.shape
        patches = xq.unfold(2, k, stride).unfold(3, k, stride)   # (B, C, OH, OW, k, k)
        oh, ow = patches.shape[2], patches.shape[3]
        a = patches.permute(0, 2, 3, 1, 4, 5).reshape(b * oh * ow, c * k * k)
        y = int8_matmul(a, wq.reshape(o, c * k * k)).reshape(b, oh, ow, o).permute(0, 3, 1, 2)
        return y.float() * (sx * sw.view(1, -1, 1, 1)) + self.bias.view(1, -1, 1, 1)


class Int8Linear(nn.Module):
    """An ``nn.Linear`` with pre-baked int8 weights: (B, in) → float32 (B, out)."""

    def __init__(self, layer: nn.Linear):
        super().__init__()
        q, s = _quant_kernel(layer.weight.detach())
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", s)
        self.register_buffer("bias", layer.bias.detach().float().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, sx = _quant_dynamic(x)
        y = int8_matmul(xq, self.weight_q)
        return y.float() * (sx * self.weight_scale) + self.bias


def _swap(module: nn.Module) -> None:
    for name, child in module.named_children():
        if isinstance(child, nn.Conv2d):
            setattr(module, name, Int8Conv2d(child))
        elif isinstance(child, nn.Linear):
            setattr(module, name, Int8Linear(child))
        else:
            _swap(child)


def quantize_params(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every conv and linear swapped for its int8
    layer (weights baked once), in eval mode and without gradients; the
    model itself is left as it was. Only the policy families of
    ``SUPPORTED``: ``ViTPolicy`` and anything else raise ``ValueError``."""
    if isinstance(model, ViTPolicy):
        raise ValueError(
            "ViTPolicy has no int8 path: the JAX package bakes its attention "
            "kernels to int8 codes but runs those layers in float, so its int8 "
            "ViT multiplies by the codes as if they were weights (ROADMAP Queue "
            "3); export the ViT without quantize")
    if not isinstance(model, SUPPORTED):
        raise ValueError(f"{type(model).__name__} has no int8 path; int8 serves "
                         f"{', '.join(m.__name__ for m in SUPPORTED)}")
    qmodel = copy.deepcopy(model)
    _swap(qmodel)
    return qmodel.eval().requires_grad_(False)


@torch.no_grad()
def quantized_apply(model: nn.Module, *inputs) -> torch.Tensor:
    """``model(*inputs)`` with every conv and linear in int8 (weights per
    channel, activations per sample, int32 sums)."""
    return quantize_params(model)(*inputs)


class FramesPolicy(nn.Module):
    """``fn(frames_u8 (B, H, W, C)) -> model(frames · 1/255)``: the serving
    contract of a single-input policy, the /255 inside."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        return self.model(frames_u8.to(torch.float32) * (1.0 / 255.0))


def make_quantized_policy(model: nn.Module) -> nn.Module:
    """``fn(frames_u8) -> logits`` with the /255 fused in, int8 inside (the
    float serving path's contract, ``serving/export.py``)."""
    return FramesPolicy(quantize_params(model))

"""Device selection and small helpers for tensor dataclasses."""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    Entry points default to ``"cuda"``. Without a card they raise instead of
    quietly running the plain PyTorch versions: the CPU is taken only when
    the caller asks for it (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def map_tensors(obj, fn):
    """Apply ``fn`` to every tensor field of dataclass ``obj`` (others kept)."""
    changes = {f.name: fn(getattr(obj, f.name))
               for f in dataclasses.fields(obj)
               if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **changes)

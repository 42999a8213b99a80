"""Small helpers of the frozen reference modules."""

from __future__ import annotations

import dataclasses


def map_tensors(obj, fn):
    """Apply ``fn`` to every tensor field of dataclass ``obj`` (others kept)."""
    import torch

    changes = {f.name: fn(getattr(obj, f.name))
               for f in dataclasses.fields(obj)
               if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **changes)

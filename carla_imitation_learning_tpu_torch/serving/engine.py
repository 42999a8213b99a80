"""Inference engine: bucketed batching and latency accounting over a policy
(the JAX package's ``serving/engine.py``).

Every request is padded with zero rows up to the next size of a fixed
ladder (powers of two up to ``max_batch``), so a server sees a small, warm
set of shapes; requests above the largest bucket run in chunks of it. The
policy is anything ``fn(frames_u8, *extras) -> logits`` on tensors: a live
model or a loaded artifact (``serving/export.py`` ``LoadedPolicy``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.device import resolve_device


def _default_buckets(max_batch: int) -> tuple[int, ...]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class InferenceEngine:
    """Pad-to-bucket batcher around ``policy(frames_u8) -> logits``.

    - ``infer(frames)`` → int32 actions (argmax): a request of any size up
      to the ladder's top is padded to the next bucket; larger requests run
      in top-bucket chunks (the tail chunk padded); an empty request runs
      as one fully padded chunk.
    - ``infer_logits(frames, *extras)`` → float32 logits, same batching;
      per-row ``extras`` (a CIL artifact's speed and command) pad and chunk
      in lockstep with the frames.
    - ``warmup()`` runs every bucket once so that the first requests pay no
      first-call costs.
    - ``stats()`` → wall latency percentiles per call, measured with the
      result fetched to the host (what a client sees), and the padded share
      of the rows, over bounded windows.

    The engine runs the policy on ``device`` (default: the policy's own
    ``device`` attribute, else the card), under ``torch.inference_mode`` in
    whichever thread calls it. ``mesh=`` (sharded serving) is not ported.
    """

    def __init__(
        self,
        policy_fn: Callable,
        *,
        max_batch: int = 256,
        buckets: Sequence[int] | None = None,
        stats_window: int = 4096,
        mesh=None,
        device: str | torch.device | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "InferenceEngine(mesh=...) is not ported yet (ROADMAP Queue 1, item 6b)")
        self._fn = policy_fn
        self.buckets = tuple(sorted(set(buckets or _default_buckets(max_batch))))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad bucket ladder {self.buckets}")
        dev = resolve_device(device if device is not None
                             else getattr(policy_fn, "device", "cuda"))
        if dev.type == "cuda" and dev.index is None:   # the card, by its index
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        # bounded windows: a long-running server must not grow its stats
        self._latencies_ms: "deque[float]" = deque(maxlen=stats_window)
        self._padded_frac: "deque[float]" = deque(maxlen=stats_window)

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def _call(self, frames: np.ndarray, extras: tuple) -> np.ndarray:
        """The policy on host arrays, on the engine's device, fetched back."""
        with torch.inference_mode():
            args = [torch.from_numpy(np.require(a, requirements=("C", "W"))).to(self.device)
                    for a in (frames, *extras)]
            return self._fn(*args).float().cpu().numpy()

    def _run_chunk(self, frames: np.ndarray, extras=()) -> np.ndarray:
        n = frames.shape[0]
        b = self._bucket_for(n)
        if n < b:
            def _pad(a):
                return np.concatenate([a, np.zeros((b - n,) + a.shape[1:], a.dtype)], axis=0)
            frames = _pad(frames)
            extras = tuple(_pad(e) for e in extras)
        logits = self._call(frames, extras)
        self._padded_frac.append(1.0 - n / b)
        return logits[:n]

    def infer_logits(self, frames, *extras) -> np.ndarray:
        """Batched logits; each of ``extras`` shares the frames' leading dim."""
        frames = np.asarray(frames)
        if frames.ndim != 4:
            raise ValueError(f"expected (B,H,W,C) uint8 frames, got {frames.shape}")
        extras = tuple(np.asarray(e) for e in extras)
        for e in extras:
            if e.shape[:1] != frames.shape[:1]:
                raise ValueError(f"extra input rows {e.shape[0]} != frames "
                                 f"rows {frames.shape[0]}")
        t0 = time.perf_counter()
        m = self.max_batch
        # an empty request is still one (fully padded) chunk: valid shape out
        stops = range(0, frames.shape[0], m) if frames.shape[0] else (0,)
        chunks = [self._run_chunk(frames[i:i + m], tuple(e[i:i + m] for e in extras))
                  for i in stops]
        out = np.concatenate(chunks, axis=0)
        self._latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def infer(self, frames, *extras) -> np.ndarray:
        return np.argmax(self.infer_logits(frames, *extras), axis=-1).astype(np.int32)

    def warmup(self, height: int, width: int, channels: int = 4,
               dtype=np.uint8, extra_specs: Sequence[tuple] = ()) -> None:
        """Run every bucket once. ``extra_specs`` are ``(shape_tail, dtype)``
        pairs of a multi-input servable's per-row inputs, e.g. ``[((),
        np.float32), ((), np.int32)]`` for CIL."""
        for b in self.buckets:
            extras = tuple(np.zeros((b,) + tuple(tail), dt) for tail, dt in extra_specs)
            self._call(np.zeros((b, height, width, channels), dtype), extras)
        # warmup calls stay out of the serving stats
        self._latencies_ms.clear()
        self._padded_frac.clear()

    def stats(self) -> dict:
        lat = np.asarray(self._latencies_ms, np.float64)
        if lat.size == 0:
            return {"count": 0}
        return {
            "count": int(lat.size),
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p95": float(np.percentile(lat, 95)),
            "latency_ms_mean": float(lat.mean()),
            "pad_waste_frac": float(np.mean(self._padded_frac)),
        }

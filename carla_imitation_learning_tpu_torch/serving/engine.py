"""Inference engine: bucketed batching and latency accounting over a policy
(the JAX package's ``serving/engine.py``).

Every request is padded with zero rows up to the next size of a fixed
ladder (powers of two up to ``max_batch``), so a server sees a small, warm
set of shapes; requests above the largest bucket run in chunks of it. The
policy is anything ``fn(frames_u8, *extras) -> logits`` on tensors: a live
model or a loaded artifact (``serving/export.py`` ``LoadedPolicy``).

Data-parallel serving (``mesh=``, the JAX package's bucket sharded over the
mesh's leading axis) is SPMD over ``torch.distributed``: every rank loads
the policy on its own device, rank 0 owns the engine that callers (and the
HTTP server) use, and every other rank runs ``follow()``. For each chunk
rank 0 broadcasts a header (operation, bucket, frame shape, extras' dtypes)
and then the padded frames and extras; every rank runs its ``bucket / n``
rows, and the logits come back to rank 0 through one all-reduce of a
zero-filled (bucket, n_out) tensor, each rank's rows written into its own
block (gloo runs only ``all_reduce`` and ``broadcast`` on CUDA tensors, and
NCCL refuses two ranks on one card). Only one thread on rank 0 may use a
sharded engine: the collectives must come in the same order on every rank.
Inputs are checked before the header goes out. A failure once it has gone
out (a policy call or a collective raising on any rank) leaves the ranks
out of step, so the engine that sees it takes the process group down
(``Mesh.abort``): the other ranks' pending collectives then raise instead
of waiting, a follower's ``follow()`` raises, and rank 0's engine refuses
every later call (``failed``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from carla_imitation_learning_tpu_torch.device import resolve_device

_RUN, _STOP = 1, 2                       # header operations
_HEADER = 7                              # op, bucket, H, W, C, frame dtype, n extras
_DTYPES = (torch.uint8, torch.float32, torch.int32, torch.int64, torch.float16,
           torch.bfloat16, torch.float64)


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
    whichever thread calls it.

    ``mesh`` (``parallel.mesh``) shards every bucket over its ``data`` axis
    (see the module's docstring): the ladder is rounded up to multiples of
    the mesh's size, rank 0 serves, the other ranks call ``follow()``, and
    ``stop()`` on rank 0 ends their loops. Extras must then be one value
    per row. After a failure inside a sharded chunk the process group is
    down and ``failed`` holds the error: every later call raises.
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
        self._fn = policy_fn
        self.buckets = tuple(sorted(set(buckets or _default_buckets(max_batch))))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad bucket ladder {self.buckets}")
        self.mesh = mesh
        self.failed: Exception | None = None
        if mesh is not None:
            # every bucket must split evenly: the ladder rounded up to
            # multiples of the mesh's size
            n = mesh.size()
            self.buckets = tuple(sorted({max(n, -(-b // n) * n) for b in self.buckets}))
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
            if self.mesh is None:
                return self._fn(*args).float().cpu().numpy()
            if self.mesh.rank() != 0:
                raise RuntimeError("a sharded engine serves from rank 0; "
                                   "the other ranks call follow()")
            self._refuse_if_failed()
            if len(args) > 5 or any(e.dim() != 1 for e in args[1:]):
                raise ValueError("a sharded engine takes at most four extras, "
                                 "one value per row")
            if any(a.dtype not in _DTYPES for a in args):
                raise ValueError(f"a sharded engine takes inputs of {_DTYPES}, "
                                 f"not {[a.dtype for a in args]}")
            header = [_RUN, *args[0].shape, _DTYPES.index(args[0].dtype), len(args) - 1]
            try:
                self._broadcast_header(header + [_DTYPES.index(e.dtype) for e in args[1:]])
                for a in args:
                    self.mesh.broadcast_(a)
                return self._sharded_rows(args).cpu().numpy()
            except Exception as e:
                self._fail(e)
                raise RuntimeError("the sharded engine failed inside a chunk; the "
                                   "process group is down") from e

    def _refuse_if_failed(self) -> None:
        if self.failed is not None:
            raise RuntimeError(f"the sharded engine stopped after a failure: "
                               f"{type(self.failed).__name__}: {self.failed}")

    def _fail(self, error: Exception) -> None:
        """The ranks are out of step: keep ``error`` and take the process
        group down, so that no rank waits on a collective that will not
        come."""
        self.failed = error
        self.mesh.abort()

    def _broadcast_header(self, values: list) -> torch.Tensor:
        """Rank 0's header to every rank: the fixed fields, then one dtype
        code an extra (room for four)."""
        head = torch.zeros(_HEADER + 4, dtype=torch.int64, device=self.device)
        if values:
            head[:len(values)] = torch.tensor(values, dtype=torch.int64)
        return self.mesh.broadcast_(head)

    def _sharded_rows(self, args: list) -> torch.Tensor:
        """This rank's rows of the bucket through the policy, and every
        rank's gathered: (bucket, n_out) float32 on every rank."""
        rows = self.mesh.rows(args[0].shape[0])
        mine = self._fn(*(a[rows] for a in args)).float()
        out = torch.zeros((args[0].shape[0],) + tuple(mine.shape[1:]), dtype=torch.float32,
                          device=mine.device)
        out[rows] = mine
        return self.mesh.all_reduce_(out)

    def follow(self) -> None:
        """The loop of a rank other than 0 under a mesh: receive each
        chunk's header and inputs from rank 0, run this rank's rows, add
        them to the gathered logits; return when rank 0 stops."""
        if self.mesh is None or self.mesh.rank() == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of a sharded engine")
        self._refuse_if_failed()
        with torch.inference_mode():
            while True:
                try:
                    head = self._broadcast_header([]).tolist()
                    if head[0] == _STOP:
                        return
                    bucket, h, w, c, code, n_extras = head[1:7]
                    args = [torch.empty((bucket, h, w, c), dtype=_DTYPES[code],
                                        device=self.device)]
                    args += [torch.empty(bucket, dtype=_DTYPES[d], device=self.device)
                             for d in head[_HEADER:_HEADER + n_extras]]
                    for a in args:
                        self.mesh.broadcast_(a)
                    self._sharded_rows(args)
                except Exception as e:
                    self._fail(e)
                    raise

    def stop(self) -> None:
        """Rank 0 of a sharded engine: end the other ranks' ``follow()``
        loops (nothing to do without a mesh, or after a failure: the
        process group is down)."""
        if self.mesh is not None and self.mesh.rank() == 0 and self.failed is None:
            self._broadcast_header([_STOP])

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

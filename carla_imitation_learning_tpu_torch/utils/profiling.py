"""Step timer, per-phase wall-clock profiler, layer spans and
``torch.profiler`` traces (the JAX package's ``utils/profiling.py``). The
timer and the phases read the host clock: a phase measures what the host
spent on it, which on the card is the enqueue unless the phase ends in a
synchronise. A trace records the host's operators and, with a card, its
kernels and copies (CUPTI), for TensorBoard's profiler plugin or Perfetto.

Layer spans name where each layer's work is launched: ``span(name)`` is a
``torch.profiler.record_function`` range while spans are on (``spans_on()``,
which ``trace_profiler`` enters for its block) and a shared no-op context
otherwise, so a fleet step or train step pays one flag test a span when no
one is tracing. The spans the port enters, innermost first where they nest:
``raster`` (kernel B, C or D in ``ops/raster_fast.py``) inside ``render``
(``render/pipeline.py``), and ``expert``, ``policy``, ``sim`` and ``render``
inside ``rollout`` (``training/closed_loop.py``); ``gather``
(``DeviceDataset.pure_batch``); ``forward``, ``backward`` and ``optimizer``
inside ``train_step`` (``training/steps.py``).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

_NO_SPAN = contextlib.nullcontext()
_spans = False


def span(name: str):
    """A named range in ``torch.profiler`` traces while spans are on; the
    shared no-op context while they are off."""
    if not _spans:
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def spans_on():
    """Turn layer spans on for the block (and back to what they were after)."""
    global _spans
    was, _spans = _spans, True
    try:
        yield
    finally:
        _spans = was


class StepTimer:
    """Throughput counter: steps/s and items/s since the last reset."""

    def __init__(self, items_per_step: int = 0):
        self.items_per_step = items_per_step
        self.reset()

    def reset(self) -> None:
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n: int = 1) -> None:
        self.steps += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def items_per_sec(self) -> float:
        return self.steps_per_sec * self.items_per_step


class SimpleProfiler:
    """Accumulates wall time per named phase."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'phase':<30}{'total_s':>10}{'calls':>8}{'mean_ms':>10}"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<30}{total:>10.3f}{n:>8}{1000 * total / n:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_profiler(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the block, written by
    ``tensorboard_trace_handler`` under ``log_dir`` as one
    ``*.pt.trace.json`` (Chrome trace format) when the block ends. It
    records the CPU and, when a card is present, CUDA activity, with the
    layer spans on; ``enabled`` False runs the block untraced."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with spans_on(), profile(activities=activities,
                             on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


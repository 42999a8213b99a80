"""Step timer, per-phase wall-clock profiler and ``torch.profiler`` traces
(the JAX package's ``utils/profiling.py``). The timer and the phases read
the host clock: a phase measures what the host spent on it, which on the
card is the enqueue unless the phase ends in a synchronise. A trace records
the host's operators and, with a card, its kernels and copies (CUPTI), for
TensorBoard's profiler plugin or Perfetto.
"""

from __future__ import annotations

import collections
import contextlib
import subprocess
import time


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
    records the CPU and, when a card is present, CUDA activity; ``enabled``
    False runs the block untraced."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


def launch_tensorboard(log_dir: str, port: int = 6006) -> "subprocess.Popen | None":
    """Start ``tensorboard --logdir log_dir`` in the background where it is
    installed; None where it is not."""
    try:
        return subprocess.Popen(
            ["tensorboard", "--logdir", str(log_dir), "--port", str(port)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
    except OSError:
        return None

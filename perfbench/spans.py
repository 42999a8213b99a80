"""The span pass: more timed calls of a cell with the program's layer spans
on, and the reduction of its trace to each layer's device time, launches,
idle and host time.

The pass records the card's activity (CUPTI) and, on the host, user-scope
ranges only (``RecordScope.USER_SCOPE``): the spans and no operator, so the
host pays little beyond the spans it enters. It turns the spans on with the
program's ``utils.profiling.spans_on`` where the program has it, and traces
a program without it as it is.

``reduce`` attributes, among the ranges named in ``LAYERS`` (torch's own
ranges, such as ``Optimizer.step#Adam.step``, are not layers):

- each device activity (kernel, copy, set) to the innermost span open at
  its launch (the ``cudaLaunchKernel``-like call of the same correlation id) on the
  launching thread or, where that thread has none open (autograd's device
  thread during ``backward``), on the main thread (the thread that enters
  the most spans) at that time; to ``outside`` where no span was open, and
  to ``unattributed`` where no launch was recorded;
- each idle gap of the card (no activity between one's end and the next's
  start) to the innermost span open on the main thread when it began, to
  ``outside`` where none was; the idle before the first activity and after
  the last in the pass's window goes to ``outside`` too, so the layers' and
  ``outside``'s idle sum to the window less the busy time;
- to each span its exclusive host time: its length less its children's.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from perfbench.trace import NOT_KERNELS, _is_annotation

LAYERS = ("rollout", "expert", "policy", "sim", "render", "raster",
          "gather", "train_step", "forward", "backward", "optimizer")
OUTSIDE, UNATTRIBUTED = "outside", "unattributed"


def _spans_on():
    try:
        from carla_imitation_learning_tpu_torch.utils.profiling import spans_on
    except ImportError:   # a program without layer spans
        return contextlib.nullcontext()
    return spans_on()


def span_pass(call, n_calls: int, barrier, cuda: bool) -> dict:
    """``n_calls`` calls of ``call()`` between two ``barrier()``s, traced
    with the spans on → ``reduce``'s dict."""
    from torch._C._profiler import ProfilerActivity, RecordScope, _ExperimentalConfig
    from torch.autograd import (
        ProfilerConfig, ProfilerState, _disable_profiler, _enable_profiler, _prepare_profiler,
    )

    activities = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    _prepare_profiler(config, activities)
    with _spans_on():
        _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
        try:
            barrier()
            t0 = time.perf_counter()
            for _ in range(n_calls):
                call()
            barrier()
            window = time.perf_counter() - t0
        finally:
            result = _disable_profiler()
    return {**reduce(*events_of(result.events()), window_ns=int(window * 1e9)),
            "calls": n_calls}


def events_of(events) -> tuple[list, dict, list]:
    """Kineto events → (spans [(name, start, end, thread)], launches
    {correlation: (time, thread)}, device [(name, start, end, correlation,
    linked correlation)]), times in ns."""
    from torch.autograd import DeviceType

    spans, launches, device = [], {}, []
    for e in events:
        annotation = _is_annotation(e)
        if e.device_type() == DeviceType.CUDA:
            if not annotation:
                device.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id(),
                               e.linked_correlation_id()))
        elif annotation:
            if e.name() in LAYERS:
                spans.append((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()))
        elif e.correlation_id():
            launches.setdefault(e.correlation_id(), (e.start_ns(), e.start_thread_id()))
    return spans, launches, device


class _Timeline:
    """The innermost span open at each instant on one thread."""

    def __init__(self, spans):
        spans = [s for s in spans if s[2] > s[1]]
        marks = sorted([(s, 1, -e, i) for i, (_, s, e, _) in enumerate(spans)]
                       + [(e, 0, 0, i) for i, (_, s, e, _) in enumerate(spans)])
        stack, times, names = [], [], []
        for t, opens, _, i in marks:
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            times.append(t)
            names.append(spans[stack[-1]][0] if stack else None)
        self.times, self.names = np.array(times, dtype=np.int64), names

    def at(self, t: int):
        i = int(np.searchsorted(self.times, t, side="right")) - 1
        return self.names[i] if i >= 0 else None

    def exclusive_ns(self) -> dict:
        out = {}
        for name, a, b in zip(self.names, self.times[:-1], self.times[1:]):
            if name is not None:
                out[name] = out.get(name, 0) + int(b - a)
        return out


def reading(ctx, module_name: str, family: str):
    """(the span pass's record of the layer a reader of ``family`` reads,
    steps in the pass), or None where the traced run has no pass, no device
    activity or no such span. The harness loads a reader once a metric as
    ``perfbench_metric_<name with _ for .>``, so the layer is the part of
    the module's name after ``<family>_``; ``loop`` reads the closed loop's
    own span, ``rollout``."""
    spans = ctx.get("spans")
    if not spans or spans["busy_s"] <= 0.0:
        return None
    layer = module_name.rsplit(family + "_", 1)[-1]
    got = spans["layers"].get("rollout" if layer == "loop" else layer)
    if got is None:
        return None
    return got, spans["calls"] * ctx["facts"]["steps_per_call"]


def reduce(spans, launches, device, window_ns: int) -> dict:
    """→ {"window_s", "busy_s", "layers": {layer: {"device_s", "launches",
    "idle_s", "host_s", "entries"}}} (see the module's docstring) over a
    window of ``window_ns``; ``layers`` holds every span entered and
    ``outside``, and ``unattributed`` where some activity had no launch."""
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s[3], []).append(s)
    timelines = {tid: _Timeline(ss) for tid, ss in by_thread.items()}
    main = max(by_thread, key=lambda tid: len(by_thread[tid])) if by_thread else None
    layers = {}

    def rec(name):
        return layers.setdefault(name, {"device_s": 0.0, "launches": 0, "idle_s": 0.0,
                                        "host_s": 0.0, "entries": 0})

    def open_at(t, tid):
        name = timelines[tid].at(t) if tid in timelines else None
        if name is None and main is not None and tid != main:
            name = timelines[main].at(t)
        return OUTSIDE if name is None else name

    for name, *_ in spans:
        rec(name)["entries"] += 1
    for tl in timelines.values():
        for name, ns in tl.exclusive_ns().items():
            rec(name)["host_s"] += ns * 1e-9
    rec(OUTSIDE)
    for name, start, end, corr, linked in device:
        launch = launches.get(corr) or launches.get(linked)
        r = rec(UNATTRIBUTED if launch is None else open_at(*launch))
        r["device_s"] += (end - start) * 1e-9
        if not any(w in name.lower() for w in NOT_KERNELS):
            r["launches"] += 1
    busy_ns = 0
    if device:
        iv = np.array(sorted((d[1], d[2]) for d in device), dtype=np.int64)
        merged_end = np.maximum.accumulate(iv[:, 1])
        gap_at = np.nonzero(iv[1:, 0] > merged_end[:-1])[0]
        extent = int(merged_end[-1] - iv[0, 0])
        gaps = iv[gap_at + 1, 0] - merged_end[gap_at]
        busy_ns = extent - int(gaps.sum())
        main_tl = timelines.get(main)
        for start, length in zip(merged_end[gap_at], gaps):
            name = main_tl.at(int(start)) if main_tl is not None else None
            rec(OUTSIDE if name is None else name)["idle_s"] += int(length) * 1e-9
        rec(OUTSIDE)["idle_s"] += (window_ns - extent) * 1e-9
    return {"window_s": window_ns * 1e-9, "busy_s": busy_ns * 1e-9, "layers": layers}
